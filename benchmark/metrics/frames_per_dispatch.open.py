"""Frames served per dispatch over the window (``dispatch_totals``)."""


def read(run):
    w = run["window"]
    return w["served_frames"] / w["dispatches"] if w["dispatches"] else None
