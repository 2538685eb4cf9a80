"""Mean host time of the ``scoring`` stage of a traced request's bucket call
(``dispatched.scoring``: the cell subsample, the score-and-select kernels,
the argmax over experts and the winner's takes), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.scoring")
