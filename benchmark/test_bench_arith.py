"""Tails and rates over all requests and the whole window, the union of
device intervals and its gaps, kernel kinds, and the frozen counts."""

import math

import pytest

from benchmark import counts, reduce, spec


def test_percentile_is_nearest_rank_over_all_values():
    vals = list(range(1, 101))  # 1..100
    assert reduce.percentile(vals, 50) == 50
    assert reduce.percentile(vals, 95) == 95
    assert reduce.percentile(vals, 100) == 100
    assert reduce.percentile([7.0], 95) == 7.0
    # Order does not matter; every value counts (no medians of chunks).
    shuffled = vals[::-1]
    assert reduce.percentile(shuffled, 95) == 95
    assert reduce.percentile([1, 2, 3, 1000], 95) == 1000


def test_percentile_of_failures_is_infinite():
    assert math.isinf(reduce.percentile([1.0] * 19 + [math.inf], 96))
    with pytest.raises(ValueError):
        reduce.percentile([], 50)


def test_rate_is_over_the_whole_window():
    assert reduce.rate(300, 2.5) == 120.0
    with pytest.raises(ValueError):
        reduce.rate(1, 0.0)


@pytest.mark.parametrize("intervals, busy, gaps", [
    ([], 0.0, []),
    ([(0, 1)], 1.0, []),
    ([(0, 2), (1, 3)], 3.0, []),                    # overlap counted once
    ([(0, 1), (2, 3)], 2.0, [(1, 2)]),
    ([(5, 6), (0, 4), (1, 2)], 5.0, [(4, 5)]),      # nested, unsorted
    ([(0, 10), (2, 3), (11, 12)], 11.0, [(10, 11)]),
])
def test_union_and_gaps(intervals, busy, gaps):
    assert reduce.union_length(intervals) == busy
    assert reduce.idle_gaps(intervals) == gaps


@pytest.mark.parametrize("name, kind", [
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("(anonymous namespace)::partial_kernel(float const*, float const*)", "score"),
    ("(anonymous namespace)::select_final_kernel(float const*, int)", "score"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized>", "conv"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float>", "conv"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true>", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>", "eager"),
    ("nvjet_tst_128x160_64x5_2x1_v_ssched_bz_TNT", "eager"),
])
def test_kernel_kinds(name, kind):
    assert reduce.kind_of(name) == kind


def test_score_ops_per_pair_is_the_itemized_formula():
    assert counts.SCORE_OPS_PER_PAIR == 41
    assert sum(n for _, n in counts.SCORE_OPS) == 41


def test_cnn_flops_match_the_published_shapes():
    cfg = spec.load("esac7_bulk_b16").cfg
    expert = counts.expert_flops(480, 640, (64, 128, 256), 512, 4)
    gating = counts.gating_flops(480, 640, (32, 64, 128, 256), 7)
    assert expert / 1e9 == pytest.approx(116.62, abs=0.01)
    assert gating / 1e9 == pytest.approx(7.92, abs=0.01)
    assert counts.cnn_flops_per_frame(cfg) == pytest.approx(7 * expert + gating)
    assert counts.score_pairs_per_frame(cfg) == 7 * 256 * 4800


def test_score_least_time_is_bound_by_operations_at_the_cell_sizes():
    cfg = spec.load("esac7_bulk_b16").cfg
    peaks = counts.PEAKS[counts.H100_SXM]
    t = counts.score_least_seconds(cfg, 16, peaks)
    assert t == pytest.approx(16 * 7 * 256 * 4800 * 41 / 67e12)
    assert counts.score_bytes(cfg, 16) / peaks["hbm_bytes"] < t


def test_the_open_loop_stamps_each_answer_on_its_own_clock():
    """``collect`` stamps a request when its event fires, in order, and
    gives up on an open head at ``until``."""
    import collections
    import threading
    import time

    from benchmark.generators import open_poisson

    class Req:
        def __init__(self):
            self.event = threading.Event()

    reqs = [Req() for _ in range(3)]
    pending = collections.deque(enumerate(reqs))
    stamps = {}
    t0 = time.perf_counter()
    timers = [threading.Timer(d, r.event.set) for d, r in zip((0.05, 0.10), reqs)]
    for t in timers:
        t.start()
    open_poisson.collect(pending, stamps, t0 + 0.3)
    for t in timers:
        t.join()
    assert sorted(stamps) == [0, 1] and [j for j, _ in pending] == [2]
    assert 0.05 <= stamps[0] - t0 < 0.09 and 0.10 <= stamps[1] - t0 < 0.14
    assert time.perf_counter() - t0 >= 0.3
