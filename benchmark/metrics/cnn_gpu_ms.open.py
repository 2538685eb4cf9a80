"""Mean card time of the ``cnn`` stage of a traced request's bucket call
(``gpu.cnn``: the images to float32 and the expert and gating CNNs): from
the card reaching the boundary that opens the stage to reaching the one that
closes it, idle gaps included (CUDA events), ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "gpu.cnn")
