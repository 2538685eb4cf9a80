"""The score-and-select kernels' share of their roofline, %: the least time
the scoring of the profiled window's frames could take (the larger of its
operations over the FP32 peak and its bytes over the memory bandwidth,
frozen counts) over the device time of ``partial_kernel`` and
``select_final_kernel``."""

from benchmark import counts, reduce


def read(run):
    prof, peaks = run["profile"], run["peaks"]
    if prof is None or peaks is None or not prof["score_frames"]:
        return None
    t = reduce.device_seconds(prof, "score")
    if t <= 0:
        return None
    return 100.0 * counts.score_least_seconds(run["cfg"], prof["score_frames"], peaks) / t
