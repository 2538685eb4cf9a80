"""Mean host time of the ``cnn`` stage of a traced request's bucket call
(``dispatched.cnn``: the images to float32 and the expert and gating CNNs),
ms."""

from benchmark import stage_spans


def read(run):
    return stage_spans.mean_ms(run, "dispatched.cnn")
