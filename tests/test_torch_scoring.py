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
    (40000, 256, 4800),  # P alone fills the card: no split
])
def test_select_cell_chunks_tile_the_cells_once(P, H, N, resident):
    """The kernels' cell split (pure Python, run by both wrappers on the
    card): the chunks tile [0, N) exactly once, each holds at least 32
    cells but the last, the grid stays within CUDA's limits, and it fills
    the card for at most CHUNK_WAVES waves wherever the cells allow."""
    S, cells = fs.cell_chunks(P, H, N, resident)
    chunks = [range(s * cells, min(N, (s + 1) * cells)) for s in range(S)]
    assert [n for ch in chunks for n in ch] == list(range(N))
    assert all(len(ch) >= fs.MIN_CHUNK_CELLS for ch in chunks[:-1]) and len(chunks[-1]) >= 1
    tiles = -(-H // 128)
    grid_x, grid_y = tiles * S, P
    assert 1 <= grid_x < 2 ** 31 and 1 <= grid_y < 65536
    blocks = P * tiles * S
    full = fs.CHUNK_WAVES * resident
    if S > 1:
        assert blocks <= full
    if N >= fs.MIN_CHUNK_CELLS * (full // (P * tiles)):
        assert blocks >= min(full, P * tiles) // 2


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
    """The score wrapper's buffers for a split from cell_chunks at an
    injected resident count: a (P, S, H) partial-sum scratch and (P, H)
    scores; the select wrapper's scratch for the same split is the same
    shape, so both entries run one partial pass."""
    zeros = torch.zeros
    op = fs._kernel_operands(zeros(B, M, H, 3, 3), zeros(B, M, H, 3), zeros(B, M, N, 3),
                             zeros(B, N, 2), zeros(B, M), zeros(2))
    P = B * M
    split = fs.cell_chunks(P, H, N, resident)
    buf = fs._score_buffers(op, torch.device("cpu"), split)
    assert (buf["S"], buf["cells"]) == split
    assert buf["part"].shape == (P, split[0], H) and buf["out"].shape == (P, H)
    assert buf["part"].dtype == buf["out"].dtype == torch.float32
    assert fs._select_buffers(op, torch.device("cpu"), split)["part"].shape == (P, split[0], H)
