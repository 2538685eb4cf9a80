"""The scoring kernels' plain versions (esac_tpu_torch.ransac.fused_scoring)
against the JAX package's Pallas kernels run in interpret mode.

On the CPU a kernel wrapper takes its plain version, so these tests hold
the plain versions -- what ``chip_smoke.py`` holds the CUDA kernels against
on the card -- to ``soft_inlier_scores_pallas(..., interpret=True)`` and
``soft_inlier_score_select(..., use_pallas=True, interpret=True)``.
Tolerance for scores: rtol 1e-5, atol 1e-3 -- sums of up to N sigmoids in
float32, accumulated in another order with another exp implementation.
Winner indices are compared exactly on fixtures without near ties; winner
pose rows are bit-equal to the input row.
"""

import ctypes
import pathlib
import re
import types

import jax
import numpy as np
import pytest
import torch

from esac_tpu.data import CAMERA_F, make_correspondence_frame
from esac_tpu.geometry.rotations import rodrigues as j_rodrigues
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac.kernel import generate_hypotheses as j_generate
from esac_tpu.ransac.pallas_scoring import (
    soft_inlier_score_select as j_select,
    soft_inlier_scores_chunked as j_chunked,
    soft_inlier_scores_pallas as j_scores,
)
from esac_tpu_torch.ransac import fused_scoring as fs

F = np.float32(CAMERA_F / 4.0)
C = np.array([80.0, 60.0], np.float32)
FRAME_KW = dict(height=120, width=160, f=CAMERA_F / 4.0, c=(80.0, 60.0))
TOL = dict(rtol=1e-5, atol=1e-3)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _fixture(seed=0, n_hyps=40):
    """One 120x160 frame (N = 300 cells) and H = 40 hypotheses: neither is
    a multiple of the TPU kernel's (8, 512) blocks."""
    frame = make_correspondence_frame(jax.random.key(seed), noise=0.02,
                                      outlier_frac=0.3, **FRAME_KW)
    rv, tv = j_generate(jax.random.key(seed + 1), frame["coords"], frame["pixels"],
                        F, C, JRansacConfig(n_hyps=n_hyps))
    return (np.asarray(frame["coords"]), np.asarray(frame["pixels"]),
            np.asarray(rv), np.asarray(jax.vmap(j_rodrigues)(rv)), np.asarray(tv))


def _port_args(Rs, ts, coords, pixels):
    return _t(Rs), _t(ts), _t(coords), _t(pixels), torch.tensor(F), _t(C)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_kernel_plain_matches_pallas_interpret(seed):
    coords, pixels, _, Rs, ts = _fixture(seed)
    want = np.asarray(j_scores(Rs, ts, coords, pixels, F, C, 10.0, 0.5, interpret=True))
    got = fs.soft_inlier_scores_kernel(*_port_args(Rs, ts, coords, pixels), 10.0, 0.5)
    assert got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("seed", [0, 2])
def test_select_kernel_plain_matches_pallas_interpret(seed):
    coords, pixels, _, Rs, ts = _fixture(seed)
    bi, bs = j_select(Rs, ts, coords, pixels, F, C, 10.0, 0.5,
                      use_pallas=True, interpret=True)
    i, s, pose = fs.soft_inlier_score_select(*_port_args(Rs, ts, coords, pixels), 10.0, 0.5)
    assert int(i) == int(bi)
    np.testing.assert_allclose(float(s), float(bs), **TOL)
    np.testing.assert_array_equal(pose[:9].numpy(), Rs[int(bi)].reshape(9))
    np.testing.assert_array_equal(pose[9:].numpy(), ts[int(bi)])


def test_batched_problems_with_per_frame_pixels():
    """P = 2 frames x 3 experts in one call, pixels (G=2, N, 2) -- one group
    per frame -- and per-problem focals: each problem equals the JAX kernel
    run on that problem alone."""
    per = [_fixture(s, n_hyps=12) for s in range(6)]
    Rs = np.stack([p[3] for p in per]).reshape(2, 3, 12, 3, 3)
    ts = np.stack([p[4] for p in per]).reshape(2, 3, 12, 3)
    coords = np.stack([p[0] for p in per]).reshape(2, 3, 300, 3)
    pixels = np.stack([per[0][1], per[0][1] + 0.5])  # (2, N, 2)
    f = np.array([[F, F * 1.1, F * 0.9]] * 2, np.float32)
    got = fs.soft_inlier_scores_kernel(_t(Rs), _t(ts), _t(coords), _t(pixels), _t(f),
                                       _t(C), 10.0, 0.5)
    sel_i, sel_s, _ = fs.soft_inlier_score_select(_t(Rs), _t(ts), _t(coords), _t(pixels),
                                                  _t(f), _t(C), 10.0, 0.5)
    assert got.shape == (2, 3, 12) and sel_i.shape == (2, 3)
    for b in range(2):
        for m in range(3):
            want = np.asarray(j_scores(Rs[b, m], ts[b, m], coords[b, m], pixels[b],
                                       f[b, m], C, 10.0, 0.5, interpret=True))
            np.testing.assert_allclose(got[b, m].numpy(), want, **TOL)
            assert int(sel_i[b, m]) == int(np.argmax(want))
            np.testing.assert_allclose(float(sel_s[b, m]), want.max(), **TOL)


def test_all_cells_behind_camera_score_exactly_zero():
    """Every cell behind the camera: the +1000 px penalty underflows every
    sigmoid to exactly 0 on both sides, and the select returns index 0 (the
    first of H = 5 tied hypotheses), never anything past H."""
    coords = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (64, 1))
    pixels = np.tile(C[None], (64, 1))
    Rs = np.tile(np.eye(3, dtype=np.float32)[None], (5, 1, 1))
    ts = np.zeros((5, 3), np.float32)
    want = np.asarray(j_scores(Rs, ts, coords, pixels, F, C, 10.0, 0.5, interpret=True))
    got = fs.soft_inlier_scores_kernel(*_port_args(Rs, ts, coords, pixels), 10.0, 0.5)
    assert (want == 0).all() and (got.numpy() == 0).all()
    i, s, _ = fs.soft_inlier_score_select(*_port_args(Rs, ts, coords, pixels), 10.0, 0.5)
    ki, ks = j_select(Rs, ts, coords, pixels, F, C, 10.0, 0.5, use_pallas=True,
                      interpret=True)
    assert int(i) == int(ki) == 0 and float(s) == float(ks) == 0.0


@pytest.mark.parametrize("dup", ["next", 15, 39])
def test_select_crafted_ties_first_max_wins(dup):
    """The winner duplicated at a later index -- in the same 8-row block,
    across a block boundary, and in the last row -- never displaces the
    first occurrence (jnp.argmax's contract, tests/test_fused_select.py)."""
    coords, pixels, _, Rs, ts = _fixture(6)
    w = int(np.argmax(np.asarray(j_scores(Rs, ts, coords, pixels, F, C, 10.0, 0.5,
                                          interpret=True))))
    d = w + 1 if dup == "next" else dup
    if d == w:
        d = w + 1
    Rs, ts = Rs.copy(), ts.copy()
    Rs[d], ts[d] = Rs[w], ts[w]
    want, _ = j_select(Rs, ts, coords, pixels, F, C, 10.0, 0.5, use_pallas=True,
                       interpret=True)
    i, _, pose = fs.soft_inlier_score_select(*_port_args(Rs, ts, coords, pixels), 10.0, 0.5)
    assert int(i) == int(want) == min(w, d)
    np.testing.assert_array_equal(pose[:9].numpy(), Rs[min(w, d)].reshape(9))


def _nan_planted():
    """Three problems of one frame's H = 40 hypotheses with NaN planted in
    t: at a hypothesis before the finite winner and at one after it (two
    NaNs), after it only, and at every hypothesis.  Returns rvecs, tvecs,
    coords, pixels and the finite winner."""
    coords, pixels, rv, _, tv = _fixture(0)
    w = int(np.argmax(np.asarray(j_scores(np.asarray(jax.vmap(j_rodrigues)(rv)), tv, coords,
                                          pixels, F, C, 10.0, 0.5, interpret=True))))
    assert 0 < w < 39, w
    tvs = np.stack([tv, tv, tv]).copy()
    tvs[0, [w - 1, w + 1], 2] = np.nan
    tvs[1, w + 1, 0] = np.nan
    tvs[2, :, 1] = np.nan
    return np.stack([rv] * 3), tvs, np.stack([coords] * 3), pixels, w


def test_every_selection_follows_argmax_on_nan_scores():
    """A NaN score wins as torch.argmax and jnp.argmax rank it: the first
    NaN by index, its score NaN, before a finite max; every NaN -> index 0
    with score NaN.  The select kernel's plain version, the "fused_select",
    "pallas" and "errmap" selections of ransac.kernel._infer_winner and
    jnp.argmax on the same scores all agree."""
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.config import RansacConfig
    from esac_tpu_torch.ransac.kernel import _infer_winner

    rv, tv, coords, pixels, w = _nan_planted()
    want_idx = [w - 1, w + 1, 0]
    args = (rodrigues(_t(rv)), _t(tv), _t(coords), _t(pixels), torch.full((3,), F), _t(C))
    scores = fs._scores_plain(*args, 10.0, 0.5)
    assert torch.isnan(scores[2]).all() and torch.isfinite(scores[:2, :w - 1]).all()
    plain_i, plain_s, plain_pose = fs._select_plain(*args, 10.0, 0.5)
    assert plain_i.tolist() == torch.argmax(scores, dim=-1).tolist() == want_idx
    assert torch.isnan(plain_s).all()
    np.testing.assert_array_equal(np.asarray(jax.numpy.argmax(scores.numpy(), axis=-1)),
                                  want_idx)
    np.testing.assert_array_equal(plain_pose[:, 9:].numpy(), tv[[0, 1, 2], want_idx])
    for impl in ("fused_select", "pallas", "errmap"):
        best, best_score, _ = _infer_winner(_t(rv), _t(tv), _t(coords), _t(pixels),
                                            torch.full((3,), F), _t(C),
                                            RansacConfig(n_hyps=40, scoring_impl=impl))
        assert best.tolist() == want_idx, impl
        assert torch.isnan(best_score).all(), impl


@pytest.mark.parametrize("impl", ["errmap", "fused"])
def test_chunked_scores_match_jax(impl):
    """The "errmap" / "fused" inference paths' chunked scoring
    (soft_inlier_scores_chunked; the fused formula chunked in _scores_plain)
    against the JAX package's soft_inlier_scores_chunked, at a chunk that
    does not divide H."""
    coords, pixels, rv, Rs, tv = _fixture(3)
    want = np.asarray(j_chunked(rv, tv, coords, pixels, F, C, 10.0, 0.5,
                                impl=impl, chunk=16))
    if impl == "errmap":
        got = fs.soft_inlier_scores_chunked(_t(rv), _t(tv), _t(coords), _t(pixels),
                                            torch.tensor(F), _t(C), 10.0, 0.5, chunk=16)
    else:
        got = fs._scores_plain(*_port_args(Rs, tv, coords, pixels), 10.0, 0.5, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_operands_reject_what_the_kernel_does_not_take():
    """The wrapper's checks (pure Python, so they run here): dtype,
    requires_grad, mismatched shapes, pixel groups that do not divide P."""
    rng = np.random.default_rng(0)
    args = [_t(rng.normal(size=s)) for s in ((8, 3, 3), (8, 3), (50, 3), (50, 2))]
    args += [torch.tensor(F), _t(C)]
    op = fs._kernel_operands(*args)
    assert op["poses"].shape == (1, 8, 12) and op["G"] == 1 and op["P"] == 1
    bad = [
        (0, args[0].double(), TypeError),
        (0, args[0].clone().requires_grad_(True), RuntimeError),
        (1, args[1][:4], ValueError),
        (2, args[2][:10], ValueError),
        (3, args[3][None].repeat(2, 1, 1), ValueError),
    ]
    for pos, val, exc in bad:
        call = list(args)
        call[pos] = val
        with pytest.raises(exc):
            fs._kernel_operands(*call)


@pytest.mark.parametrize("resident", [8 * 132, 2 * 132])
@pytest.mark.parametrize("P,H,N", [
    (28, 256, 4800),   # 4 frames x 7 experts, 640x480: the serving shape
    (112, 256, 4800),  # the 16-frame bucket
    (14, 256, 4800),   # the 1-frame bucket (2 lanes)
    (3, 40, 300),      # ragged H and N
    (1, 256, 4800),
    (1, 40, 300),
    (1, 1, 1),
    (40000, 256, 4800),  # P alone fills the card: the same split
])
def test_select_cell_chunks_tile_the_cells_once(P, H, N, resident):
    """The kernels' cell split (pure Python, run by both wrappers on the
    card): the chunks tile [0, N) exactly once, each holds CHUNK_CELLS
    cells but the last, the grid stays within CUDA's limits, and the split
    depends on N alone -- whatever the number of problems P sharing the
    launch and whatever the card holds (``resident``), so a frame's
    partials are added in one association in every frame bucket."""
    S, cells = fs.cell_chunks(N)
    chunks = [range(s * cells, min(N, (s + 1) * cells)) for s in range(S)]
    assert [n for ch in chunks for n in ch] == list(range(N))
    assert all(len(ch) == fs.CHUNK_CELLS for ch in chunks[:-1]) and len(chunks[-1]) >= 1
    tiles = -(-H // 128)
    grid_x, grid_y = tiles * S, P
    assert 1 <= grid_x < 2 ** 31 and 1 <= grid_y < 65536
    meta = torch.device("meta")  # shapes only: nothing is allocated
    for lanes in (1, 2, 3):  # the same problems in 1, 2 and 3 times the batch
        op = dict(P=lanes * P, H=H, N=N)
        buf = fs._partial_buffers(op, meta)
        assert (buf["S"], buf["cells"]) == (S, cells)
        assert buf["part"].shape == (lanes * P, S, H)
    # The card's resident blocks do not enter the split: S is as many
    # chunks as the cells make, and the grid is one wave or many.
    assert S == -(-N // fs.CHUNK_CELLS) and resident > 0


CSRC = pathlib.Path(fs.__file__).resolve().parents[1] / "csrc" / "soft_inlier.cu"
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_signatures(src: str) -> dict:
    """{name: [ctypes type per parameter]} of every function defined in the
    ``extern "C"`` block of a CUDA source: a pointer maps to c_void_p."""
    block = src.split('extern "C" {', 1)[1]
    sigs = {}
    for m in re.finditer(r"^int\s+(\w+)\(([^)]*)\)\s*\{", block, re.M):
        params = [" ".join(a.split()) for a in m.group(2).split(",") if a.strip()]
        sigs[m.group(1)] = [ctypes.c_void_p if "*" in a else C_TYPES[a.rsplit(" ", 1)[0]]
                            for a in params]
    return sigs


def test_typed_argtypes_match_the_c_signatures():
    """fused_scoring._typed, run on a stand-in for the library (there is none
    here), declares for every function of soft_inlier.cu's extern "C" block
    as many argtypes as the C signature has parameters, each of the matching
    ctypes type, and an int result: a mismatch would only show on the card."""
    sigs = _c_signatures(CSRC.read_text())
    assert {"esac_soft_inlier_scores", "esac_soft_inlier_select"} <= set(sigs)
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in sigs})
    fs._typed(lib)
    for name, want in sigs.items():
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype is ctypes.c_int, name
    assert len(sigs["esac_soft_inlier_scores"]) == 16
    assert len(sigs["esac_soft_inlier_select"]) == 18


@pytest.mark.parametrize("resident", [10 * 132, 2 * 132])
@pytest.mark.parametrize("B,M,H,N", [
    (4, 7, 256, 4800),   # the serving shape, P = 28
    (16, 7, 256, 4800),  # the 16-frame bucket, P = 112
    (3, 1, 40, 300),     # ragged H and N
])
def test_score_buffers_follow_the_cell_split(B, M, H, N, resident):
    """The score wrapper's buffers for the split from cell_chunks (the
    default) and for an explicit one (the ``split`` of
    tools/kernel_bound.py, a cells-per-chunk of ``resident // 132 * 8``): a
    (P, S, H) partial-sum scratch and (P, H) scores; the select wrapper's
    scratch for the same split is the same shape, so both entries run one
    partial pass."""
    zeros = torch.zeros
    op = fs._kernel_operands(zeros(B, M, H, 3, 3), zeros(B, M, H, 3), zeros(B, M, N, 3),
                             zeros(B, N, 2), zeros(B, M), zeros(2))
    P, cpu = B * M, torch.device("cpu")
    cells = resident // 132 * 8
    for split in (fs.cell_chunks(N), (-(-N // cells), cells)):
        buf = fs._score_buffers(op, cpu, None if split == fs.cell_chunks(N) else split)
        assert (buf["S"], buf["cells"]) == split
        assert buf["part"].shape == (P, split[0], H) and buf["out"].shape == (P, H)
        assert buf["part"].dtype == buf["out"].dtype == torch.float32
        assert fs._select_buffers(op, cpu, split)["part"].shape == (P, split[0], H)


# ------------------------------------------------------------- gradients
#
# Criterion of tests/test_pallas_scoring.py:79-136: two correct float32
# backwards of a signed sum of sigmoids differ by f32 conditioning (up to
# ~0.7% relative), so the port's gradient is held by its distance to a
# float64 oracle of the same math -- at most 2x the JAX custom_vjp's own
# distance + 1e-3 -- and, beside it, allclose to JAX's at rtol 2e-2,
# atol 0.4.  The oracle is the error-map formulation in torch float64
# (jax.experimental.enable_x64, which that JAX test imports, is gone from
# this JAX version).


def _grad_fixture():
    """tests/test_pallas_scoring.py's gradient fixture: N = 300 cells,
    H = 24 hypotheses, a random cotangent."""
    frame = make_correspondence_frame(jax.random.key(7), noise=0.02, outlier_frac=0.3,
                                      **FRAME_KW)
    rv, tv = j_generate(jax.random.key(8), frame["coords"], frame["pixels"], F, C,
                        JRansacConfig(n_hyps=24))
    cot = np.asarray(jax.random.normal(jax.random.key(9), (24,)))
    return (np.asarray(jax.vmap(j_rodrigues)(rv)), np.asarray(tv),
            np.asarray(frame["coords"]), np.asarray(frame["pixels"]), cot)


def _oracle_grads(Rs, ts, coords, pixels, cot, winner=None):
    """float64 gradients of sum(scores * cot) -- or of the winner's score
    times cot -- by the error-map math, with respect to (Rs, ts, coords,
    pixels, f, c)."""
    from esac_tpu_torch.geometry.camera import reprojection_errors
    from esac_tpu_torch.ransac.scoring import soft_inlier_score

    xs = [torch.tensor(np.asarray(x, np.float64), requires_grad=True)
          for x in (Rs, ts, coords, pixels, float(F), C)]
    R, t, co, px, f, c = xs
    if winner is not None:
        R, t = R[winner][None], t[winner][None]
    errs = reprojection_errors(R, t, co[None], px[None], f, c)
    torch.sum(soft_inlier_score(errs, 10.0, 0.5) * torch.tensor(np.asarray(cot, np.float64))).backward()
    return [x.grad.numpy() for x in xs]


def _port_grads(fn, Rs, ts, coords, pixels, f=F):
    xs = [_t(x).requires_grad_(True) for x in (Rs, ts, coords, pixels, f, C)]
    fn(*xs).backward()
    return xs, [x.grad.numpy() for x in xs]


def _hold_to_oracle(port, jax_grads, oracle):
    for p, j, o in zip(port, jax_grads, oracle):
        j = np.asarray(j, np.float64)
        assert np.abs(p - o).max() <= 2.0 * np.abs(j - o).max() + 1e-3
        np.testing.assert_allclose(p, j, rtol=2e-2, atol=0.4)


def test_scores_function_backward_matches_jax_custom_vjp():
    """SoftInlierScores' backward (the chunked plain recompute) against the
    JAX package's custom_vjp (_scores_bwd) for Rs, ts and coords, and
    against the float64 oracle for pixels, f and c as well."""
    Rs, ts, coords, pixels, cot = _grad_fixture()

    def j_loss(R, t, co):
        return jax.numpy.sum(j_scores(R, t, co, pixels, F, C, 10.0, 0.5, interpret=True)
                             * cot)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(Rs, ts, coords)
    xs, got = _port_grads(lambda *a: torch.sum(
        fs.soft_inlier_scores_kernel(*a, 10.0, 0.5, chunk=7) * _t(cot)), Rs, ts, coords,
        pixels)
    oracle = _oracle_grads(Rs, ts, coords, pixels, cot)
    _hold_to_oracle(got[:3], want, oracle[:3])
    for p, o in zip(got[3:], oracle[3:]):
        np.testing.assert_allclose(p, o, rtol=2e-2, atol=0.4 * max(1.0, np.abs(o).max()))
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in got)


def test_scores_function_chunking_changes_no_hypothesis_gradient():
    """The backward recompute's hypothesis chunk bounds its memory and
    changes no arithmetic of a hypothesis' own gradient: Rs and ts
    gradients are bit-equal across chunks; the shared inputs' gradients are
    sums over the chunks, equal to float32 rounding."""
    Rs, ts, coords, pixels, cot = _grad_fixture()
    runs = [_port_grads(lambda *a, k=k: torch.sum(
        fs.soft_inlier_scores_kernel(*a, 10.0, 0.5, chunk=k) * _t(cot)), Rs, ts, coords,
        pixels)[1] for k in (1, 5, 24, 64)]
    for other in runs[1:]:
        np.testing.assert_array_equal(other[0], runs[0][0])
        np.testing.assert_array_equal(other[1], runs[0][1])
        for a, b in zip(other[2:], runs[0][2:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_select_function_backward_is_winner_only_and_matches_jax():
    """SoftInlierScoreSelect's backward recomputes the winner's score alone
    (_select_bwd): Rs and ts gradients vanish outside the winner's row,
    and the gradients match the JAX custom_vjp of
    soft_inlier_score_select(use_pallas=True, interpret=True)."""
    Rs, ts, coords, pixels, cot = _grad_fixture()

    def j_loss(R, t, co):
        _, s = j_select(R, t, co, pixels, F, C, 10.0, 0.5, use_pallas=True, interpret=True)
        return s * cot[0]

    want = jax.grad(j_loss, argnums=(0, 1, 2))(Rs, ts, coords)
    winner = []

    def port_loss(*a):
        i, s, _ = fs.soft_inlier_score_select(*a, 10.0, 0.5)
        winner.append(int(i))
        return s * float(cot[0])

    _, got = _port_grads(port_loss, Rs, ts, coords, pixels)
    w = winner[0]
    assert w == int(j_select(Rs, ts, coords, pixels, F, C, 10.0, 0.5, use_pallas=True,
                             interpret=True)[0])
    rows = np.abs(got[0]).sum((1, 2)) + np.abs(got[1]).sum(1)
    assert rows[w] > 0 and np.count_nonzero(rows) == 1
    _hold_to_oracle(got[:3], want,
                    _oracle_grads(Rs, ts, coords, pixels, cot[:1], winner=w)[:3])


def test_select_function_pose_row_passes_its_gradient_to_the_winner():
    """The winner's pose row is the input row, so its cotangent lands on
    the winner's R and t unchanged (the score's part is zero here)."""
    Rs, ts, coords, pixels, _ = _grad_fixture()
    cot = np.arange(12, dtype=np.float32)
    xs = [_t(x).requires_grad_(True) for x in (Rs, ts)]
    i, _, pose = fs.soft_inlier_score_select(*xs, _t(coords), _t(pixels), torch.tensor(F),
                                             _t(C), 10.0, 0.5)
    torch.sum(pose * _t(cot)).backward()
    want_R, want_t = np.zeros_like(Rs), np.zeros_like(ts)
    want_R[int(i)], want_t[int(i)] = cot[:9].reshape(3, 3), cot[9:]
    np.testing.assert_array_equal(xs[0].grad.numpy(), want_R)
    np.testing.assert_array_equal(xs[1].grad.numpy(), want_t)


def test_wrappers_route_through_functions_only_under_grad():
    """An input that requires grad sends each wrapper through its Function
    (the same forward values); without one, or under no_grad, the call is
    the plain forward with no graph."""
    Rs, ts, coords, pixels, _ = _grad_fixture()
    args = [_t(x) for x in (Rs, ts, coords, pixels)] + [torch.tensor(F), _t(C), 10.0, 0.5]
    plain_scores = fs.soft_inlier_scores_kernel(*args)
    plain_sel = fs.soft_inlier_score_select(*args)
    assert plain_scores.grad_fn is None and plain_sel[1].grad_fn is None
    for pos in range(6):
        call = list(args)
        call[pos] = call[pos].clone().requires_grad_(True)
        s = fs.soft_inlier_scores_kernel(*call)
        i, b, p = fs.soft_inlier_score_select(*call)
        assert type(s.grad_fn).__name__ == "SoftInlierScoresBackward"
        assert type(b.grad_fn).__name__ == "SoftInlierScoreSelectBackward"
        assert not i.requires_grad
        assert torch.equal(s, plain_scores) and torch.equal(i, plain_sel[0])
        assert torch.equal(b, plain_sel[1]) and torch.equal(p, plain_sel[2])
        with torch.no_grad():
            assert fs.soft_inlier_scores_kernel(*call).grad_fn is None
