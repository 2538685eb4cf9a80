"""The CNNs' share of their roofline, %: the FLOPs of every frame the
convolutions computed in the profiled window (padding lanes included),
from the frozen counts, over the device time of the convolution kernels
times the bf16 tensor-core peak."""

from benchmark import counts, reduce


def read(run):
    prof, peaks = run["profile"], run["peaks"]
    if prof is None or peaks is None or not prof["conv_frames"]:
        return None
    t = reduce.device_seconds(prof, "conv")
    if t <= 0:
        return None
    flops = prof["conv_frames"] * counts.cnn_flops_per_frame(run["cfg"])
    return 100.0 * flops / (t * peaks["bf16_flops"])
