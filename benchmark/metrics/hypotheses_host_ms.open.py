"""Mean host time of the ``hypotheses`` stage of a traced request's bucket call
(``dispatched.hypotheses``: gather, P3P and polish of every hypothesis), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.hypotheses")
