"""Blind-rotation launches of the engine's route over the untraced
stretch (the wrapper's `launches`, graph replays included), a vector slot
evaluated."""


def read(run, name):
    w = run.window
    return w.counts["launches"] / w.slots if w.slots else None
