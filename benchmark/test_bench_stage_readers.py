"""The readers of the bucket call's stages and of the unattributed idle
share, on hand-made run records."""

import pytest

from benchmark import spec

STAGES = ("cnn", "sampling", "hypotheses", "scoring", "refine")


def _run(spans=(), idle_gaps=None, window_s=2.0, kernels=()):
    prof = None if idle_gaps is None else {"idle_gaps": idle_gaps, "window_s": window_s,
                                           "busy_s": 1.0, "kernels": list(kernels)}
    return {"cfg": {}, "cell": {}, "mix": {}, "peaks": None, "profile": prof,
            "window": {"spans": list(spans), "served_frames": 0, "dispatches": 0,
                       "window_s": 0.0}}


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers_average_the_traced_requests_that_carry_the_stage(stage):
    spans = [{"dispatched": 0.1, f"dispatched.{stage}": 0.02, f"gpu.{stage}": 0.005},
             {"dispatched": 0.1, f"dispatched.{stage}": 0.04, f"gpu.{stage}": 0.007},
             {"dispatched": 0.1}]  # a request of a program without stages
    run = _run(spans)
    assert spec.reader(f"{stage}_host_ms.open")(run) == pytest.approx(30.0)
    assert spec.reader(f"{stage}_gpu_ms.open")(run) == pytest.approx(6.0)


@pytest.mark.parametrize("side", ["host", "gpu"])
def test_stage_readers_give_nothing_for_a_program_without_stages(side):
    run = _run([{"coalesced": 0.05, "staged": 0.01, "dispatched": 0.1}])
    for stage in STAGES:
        assert spec.reader(f"{stage}_{side}_ms.open")(run) is None


def test_unattributed_idle_share_reads_the_no_host_op_gaps():
    gaps = [["no host op", 0.5], ["cudaLaunchKernel", 0.2], ["esac.cnn", 0.1]]
    read = spec.reader("unattributed_idle_share.open")
    assert read(_run(idle_gaps=gaps, window_s=2.0)) == pytest.approx(25.0)
    assert spec.reader("unattributed_idle_share.bulk")(
        _run(idle_gaps=gaps, window_s=4.0)) == pytest.approx(12.5)


def test_unattributed_idle_share_without_the_label():
    read = spec.reader("unattributed_idle_share.open")
    short = [["esac.cnn", 0.3], ["esac.hold", 0.1]]
    assert read(_run(idle_gaps=short)) == 0.0  # every gap was listed
    assert read(_run()) is None  # untraced: no profile
    assert read(_run(idle_gaps=short, window_s=0.0)) is None


# Device intervals (name, start us, duration us, kind) with idle gaps of
# 200 us and 600 us between them: 0.0008 s of idle in all.
KERNELS = [("k", 0.0, 100.0, "eager"), ("k", 300.0, 100.0, "eager"),
           ("k", 1000.0, 100.0, "eager")]


@pytest.mark.parametrize("tenth, bound_s", [
    (0.00005, 0.00005),   # the tenth label bounds it: 0.0003 s lies unlisted
    (0.000078, 0.00002),  # the unlisted idle time bounds it
])
def test_unattributed_idle_share_bounds_a_label_below_a_full_list(tenth, bound_s):
    read = spec.reader("unattributed_idle_share.open")
    full = [[f"esac.op{i}", tenth] for i in range(10)]
    assert read(_run(idle_gaps=full, kernels=KERNELS, window_s=2.0)) == pytest.approx(
        100.0 * bound_s / 2.0)
