"""Means of the nested stages of traced requests' bucket calls: the
``dispatched.<stage>`` (host) and ``gpu.<stage>`` (card) entries the
program adds to each traced request's span durations.  A program without
them gives nothing to read."""


def mean_ms(run, key: str):
    """Mean of ``key`` over the traced requests that carry it, ms (None
    where none does)."""
    vals = [s[key] for s in run["window"]["spans"] if key in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
