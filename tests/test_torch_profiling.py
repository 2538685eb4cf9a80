"""The port's FLOP and roofline model (esac_tpu_torch.utils.profiling)
against the JAX package's (esac_tpu.utils.profiling).

The hand counts and formulas are the JAX package's, so the same inputs give
the same numbers.  The peak tables differ on purpose: the port's hold the
H100 SXM data sheet's figures under the card's PyTorch name and no TPU
figure.  For a card in neither table both summaries are equal dicts; for
the H100 the JAX summary, given the port's figures under that name, has
the same numbers under the JAX package's key names.  The port's count of
its own scoring formula stands where the JAX package asks XLA's cost
model, and is held within 2x of the 41 operations a pair that
chip_smoke.py's bound uses (the same 2x as tests/test_profiling.py).
"""

import pytest

from esac_tpu.utils import profiling as jprof
from esac_tpu_torch.utils import profiling as prof

H100 = "NVIDIA H100 80GB HBM3"


def test_per_stage_constants_and_flops_per_hypothesis_equal_jax():
    for name in ("SCORE_FLOPS_PER_CELL", "P3P_FLOPS_BASE", "P3P_FLOPS_PER_POLISH",
                 "REFINE_FLOPS_PER_CELL_ITER", "REFINE_FLOPS_SOLVE",
                 "SCORE_HBM_BYTES_PER_CELL"):
        assert getattr(prof, name) == getattr(jprof, name), name
    for args in ((4800,), (1200, 2, 4, 1.0), (300, 0, 8, 1 / 256)):
        assert prof.flops_per_hypothesis(*args) == jprof.flops_per_hypothesis(*args)


def test_peak_tables_hold_the_h100_data_sheet_only():
    for table in (prof.DEVICE_PEAK_FLOPS, prof.DEVICE_FP32_FLOPS, prof.DEVICE_HBM_BYTES_PER_S):
        assert list(table) == [H100]
    assert (prof.DEVICE_PEAK_FLOPS[H100], prof.DEVICE_FP32_FLOPS[H100],
            prof.DEVICE_HBM_BYTES_PER_S[H100]) == (989e12, 67e12, 3.35e12)


@pytest.mark.parametrize("impl", ["errmap", "pallas", "fused"])
@pytest.mark.parametrize("kind", [None, "CPU", "TPU v5 lite"])
def test_summary_equals_jax_for_a_card_in_neither_table(kind, impl):
    """No entry in the port's tables: the JAX dict without its TPU entries."""
    want = jprof.pipeline_flop_summary(550_000.0, None, "tag", 2400, 128, impl)
    assert prof.pipeline_flop_summary(550_000.0, kind, "tag", 2400, 128, impl) == want
    assert prof.scoring_roofline(1.0, kind) is None


@pytest.mark.parametrize("impl", ["errmap", "pallas"])
def test_summary_and_roofline_equal_jax_given_the_same_peaks(impl, monkeypatch):
    """The JAX formulas over the port's H100 figures: the same numbers,
    under the port's names for the FP32 peak and its binding resource."""
    monkeypatch.setitem(jprof.DEVICE_PEAK_FLOPS, H100, prof.DEVICE_PEAK_FLOPS[H100])
    monkeypatch.setitem(jprof.DEVICE_VPU_F32_FLOPS_EST, H100, prof.DEVICE_FP32_FLOPS[H100])
    monkeypatch.setitem(jprof.DEVICE_HBM_BYTES_PER_S, H100, prof.DEVICE_HBM_BYTES_PER_S[H100])
    want = jprof.pipeline_flop_summary(2.5e6, H100, "live", 4800, 256, impl)
    got = prof.pipeline_flop_summary(2.5e6, H100, "live", 4800, 256, impl)
    rename = {"vpu_f32_peak_est_tflops": "fp32_peak_tflops"}
    want_roof = {rename.get(k, k): v for k, v in want.pop("roofline").items()}
    got_roof = got.pop("roofline")
    assert want_roof.pop("binding_resource") == {"FP32": "VPU-f32"}.get(
        got_roof.pop("binding_resource"), "HBM")
    for d in (want, got, want_roof, got_roof):
        d.pop("peak_note", None)
        d.pop("note", None)
    assert got == want and got_roof == want_roof
    assert got["pct_of_bf16_peak"] > 0


def test_roofline_ceiling_is_consistent_and_fused_binds_fp32():
    r = prof.scoring_roofline(550_000.0, H100, n_cells=4800, scoring_impl="errmap")
    t_fp32 = prof.SCORE_FLOPS_PER_CELL / (r["fp32_peak_tflops"] * 1e12)
    t_hbm = r["hbm_bytes_per_cell_model"] / (r["hbm_gbps"] * 1e9)
    assert r["max_hyps_per_sec_model"] == pytest.approx(1.0 / (max(t_fp32, t_hbm) * 4800),
                                                        rel=0.01)
    assert r["binding_resource"] == "HBM"
    fused = prof.scoring_roofline(550_000.0, H100, scoring_impl="pallas")
    assert fused["binding_resource"] == "FP32"
    assert fused["max_hyps_per_sec_model"] >= r["max_hyps_per_sec_model"]


def test_score_ops_per_pair_is_within_2x_of_the_bound_count():
    """The port's scoring formula counted op by op (39: R X + t 18, clamp,
    projection 8, the squared distance 4, sqrt, the penalty's compare, add
    and select, tau - err, beta *, sigmoid, the sum) against chip_smoke.py's
    41 operations a pair and the hand count."""
    measured = prof.score_ops_per_pair(n_cells=300, n_hyps=16)
    assert measured == prof.score_ops_per_pair(n_cells=600, n_hyps=8)
    assert 0.5 < measured / 41 < 2.0
    assert 0.5 < measured / prof.SCORE_FLOPS_PER_CELL < 2.0
