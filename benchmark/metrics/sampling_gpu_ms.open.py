"""Mean card time of the ``sampling`` stage of a traced request's bucket call
(``gpu.sampling``: the per-frame generators, with the seed readback that
waits for the CNNs on the card, and the correspondence sets): from the card
reaching the boundary that opens the stage to reaching the one that closes
it, idle gaps included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.sampling")
