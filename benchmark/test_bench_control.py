"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision step below the configuration's, in the
program's place) and faults planted under the dispatcher, each through the
rest of a run."""

import time

import pytest
import torch

from benchmark import compare, control, harness


def _shift_pose(out):
    """An answer altered where it is produced: the served translation 25 cm
    off."""
    return dict(out, tvec=out["tvec"] + 0.25)


def _half_batch(out):
    """Half of the batch left out: the second half of the lanes carries
    the first half's answers."""
    B = next(iter(out.values())).shape[0]
    keep = torch.arange(B) % max(1, B // 2)
    return {k: v[keep.to(v.device)] for k, v in out.items()}


@pytest.mark.parametrize("workload", ["esac7_bulk_b16", "esac7_open_single"])
@pytest.mark.parametrize("fault", [None, _shift_pose, _half_batch])
def test_faults_come_out_not_correct(tiny_cell, workload, fault):
    """The open cell offers 200 requests a second, so that dispatches
    coalesce several frames whatever the host's speed (a planted fault
    that leaves half of a batch out has nothing to leave out of a
    dispatch of one frame)."""
    wl = tiny_cell(workload, compute_dtype="float32")
    wl.cell = dict(wl.cell, rate_per_s=200.0)
    res = harness.run_cell(wl, 987654321, 1.0, False, "cpu", time.perf_counter(),
                           fault=fault)
    assert res["correct"] is (fault is None), res["compared"]


@pytest.mark.parametrize("precision", ["cnn_fp8", "head3_fp8", "head3_skip"])
def test_the_control_comes_out_not_correct(tiny_cell, precision):
    """The CNNs one step below bfloat16, and the experts' head 3 x 3
    convolutions alone lowered or left out, each in the program's place."""
    wl = tiny_cell("esac7_bulk_b16")
    for seed in (1, 2, 3):
        nums = control.control_numbers(wl, seed, torch.device("cpu"), precision)
        assert not compare.judge(nums, wl.cfg["limits"])[0], nums


@pytest.mark.card
@pytest.mark.parametrize("workload", ["esac7_bulk_b16", "esac7_open_single"])
def test_on_the_card_sound_runs_pass_and_the_control_fails(card, workload):
    """At the cell's widths and image size: a short sound run judged on a
    sample of 8 frames, then each control on the cell's own sample (the
    worst of 48 frames: scoring in bfloat16 opens its gap on some frames
    only)."""
    from benchmark import spec

    wl = spec.load(workload)
    cell = wl.cell
    wl.cell = dict(cell, correct_sample=8)
    res = harness.run_cell(wl, 5150, 2.0, False, card, time.perf_counter())
    assert res["correct"], res["compared"]
    wl.cell = cell
    for precision in ("cnn_fp8", "head3_fp8", "score_bf16"):
        nums = control.control_numbers(wl, 5151, card, precision)
        assert not compare.judge(nums, wl.cfg["limits"])[0], (precision, nums)
