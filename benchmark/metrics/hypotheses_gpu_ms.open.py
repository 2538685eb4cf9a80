"""Mean card time of the ``hypotheses`` stage of a traced request's bucket call
(``gpu.hypotheses``: gather, P3P and polish of every hypothesis): from the
card reaching the boundary that opens the stage to reaching the one that
closes it, idle gaps included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.hypotheses")
