"""Share of the real frames' selected (frame, expert) pairs that capacity
dropped in the traced routed dispatches, %: the sum of ``route.dropped``
over that of ``route.pairs`` and ``route.dropped``.  A dropped pair is
one expert fewer for its frame: a wrong answer where it was the frame's
room."""

from benchmark import route_counts


def read(run):
    sums = route_counts.dispatch_sums(run)
    if sums is None:
        return None
    pairs, dropped, _ = sums
    return 100.0 * dropped / (pairs + dropped)
