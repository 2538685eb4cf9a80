"""The CNNs' share of their roofline over the profiled window of an open
loop, %: the FLOPs of the work the served frames asked for (the frozen
counts: at a routed configuration K expert CNNs and the gating a frame,
not the padded blocks) over the device time of the convolution kernels
times the bf16 tensor-core peak.  The bulk reader's arithmetic, on the
frames the window answered."""

from benchmark import spec


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    bulk = spec.reader("cnn_roofline.bulk")
    return bulk(dict(run, profile=dict(prof, conv_frames=prof["frames"])))
