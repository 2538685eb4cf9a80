"""The whole dispatch's share of the chip's bf16 peak, %: the model FLOPs
of every frame served in the traced run's window (the CNNs and the
scoring, frozen counts) over that window, over 989 TFLOP/s."""

from benchmark import counts


def read(run):
    w, peaks = run["window"], run["peaks"]
    if peaks is None or not w["served_frames"] or w["window_s"] <= 0:
        return None
    cfg = run["cfg"]
    per = counts.cnn_flops_per_frame(cfg) + counts.SCORE_OPS_PER_PAIR * \
        counts.score_pairs_per_frame(cfg)
    return 100.0 * w["served_frames"] * per / w["window_s"] / peaks["bf16_flops"]
