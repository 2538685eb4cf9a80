"""Mean host time of the ``sampling`` stage of a traced request's bucket call
(``dispatched.sampling``: the per-frame generators, with the seed readback
that waits for the CNNs on the card, and the correspondence sets), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.sampling")
