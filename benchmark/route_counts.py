"""The routing counts of the traced dispatches of a window: a traced
request of a gating-first routed dispatch carries its dispatch's
``route.pairs`` (the real frames' selected pairs capacity kept),
``route.dropped`` (those it dropped) and ``route.slots`` (the expert-CNN
images convolved).  A program without them gives nothing to read."""

from benchmark import counts

KEYS = ("route.pairs", "route.dropped", "route.slots")


def dispatch_sums(run):
    """(pairs, dropped, slots) summed over the window's traced dispatches,
    or None where no request carries the counts.  Every request of the
    mix is one frame, and each frame selects K pairs, so a dispatch of n
    requests holds K n = pairs + dropped of them: each request weighs
    K / (pairs + dropped), and a dispatch's requests count it once."""
    k = counts.served_experts(run["cfg"])
    sums = [0.0, 0.0, 0.0]
    found = False
    for s in run["window"]["spans"]:
        if not all(key in s for key in KEYS):
            continue
        selected = s["route.pairs"] + s["route.dropped"]
        if selected <= 0:
            continue
        found = True
        for i, key in enumerate(KEYS):
            sums[i] += s[key] * k / selected
    return tuple(sums) if found else None
