"""Share of the expert-CNN images the traced routed dispatches convolved
that carried a real frame's pair, %: the sum of ``route.pairs`` over the
sum of ``route.slots`` (every expert's fixed block, padding included)."""

from benchmark import route_counts


def read(run):
    sums = route_counts.dispatch_sums(run)
    if sums is None or sums[2] <= 0:
        return None
    pairs, _, slots = sums
    return 100.0 * pairs / slots
