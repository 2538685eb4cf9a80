"""Mean host time of the ``route`` stage of a traced routed request's
bucket call (``dispatched.route``: the gating CNN, each frame's top K and
the slot assignment, issued), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.route")
