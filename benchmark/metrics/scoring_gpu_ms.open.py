"""Mean card time of the ``scoring`` stage of a traced request's bucket call
(``gpu.scoring``: the cell subsample, the score-and-select kernels, the
argmax over experts and the winner's takes): from the card reaching the
boundary that opens the stage to reaching the one that closes it, idle gaps
included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.scoring")
