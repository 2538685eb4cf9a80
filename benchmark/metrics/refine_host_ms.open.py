"""Mean host time of the ``refine`` stage of a traced request's bucket call
(``dispatched.refine``: IRLS refinement of the winner), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.refine")
