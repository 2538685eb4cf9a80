"""Mean card time of the ``route`` stage of a traced routed request's
bucket call (``gpu.route``: the gating CNN, the top K and the slot
assignment), from the card reaching the boundary that opens the stage to
reaching the one that closes it, idle gaps included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.route")
