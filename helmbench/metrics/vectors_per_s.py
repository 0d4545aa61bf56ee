"""Vectors served over the window's whole time, on the host clock: the
window closes at the completion of the call in flight, and its time is
taken to that completion."""


def read(run, name):
    w = run.window
    return w.vectors / w.seconds if w.seconds > 0 else None
