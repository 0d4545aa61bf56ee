"""Real slots bootstrapped over the untraced stretch (the radix layer's
`SLOTS`; the level plan's real slots in gates mode), a vector slot
evaluated."""


def read(run, name):
    w = run.window
    return w.counts["bootstraps"] / w.slots if w.slots else None
