"""Share of the convolutions of the traced dispatches that ran with their
bias, residual add and ReLU in cuDNN's epilogue, %: the sum of
``cnn.fused_convs`` over that of ``cnn.convs``.  A dispatch's counts ride
its first traced request alone, so the sums count each dispatch once.  A
program without the counts gives nothing to read."""

KEYS = ("cnn.convs", "cnn.fused_convs")


def read(run):
    convs = fused = 0.0
    for s in run["window"]["spans"]:
        if all(key in s for key in KEYS):
            convs += s["cnn.convs"]
            fused += s["cnn.fused_convs"]
    return 100.0 * fused / convs if convs > 0 else None
