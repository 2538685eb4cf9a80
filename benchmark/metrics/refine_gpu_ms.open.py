"""Mean card time of the ``refine`` stage of a traced request's bucket call
(``gpu.refine``: IRLS refinement of the winner): from the card reaching the
boundary that opens the stage to reaching the one that closes it, idle gaps
included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.refine")
