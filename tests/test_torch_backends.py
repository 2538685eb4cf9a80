"""The port's C++ backend (esac_tpu_torch.backends) against the JAX
package's (esac_tpu.backends), on the CPU.

Both bind the same C source, esac_cpp/esac.cpp, with the same g++ flags and
C signatures, so the same numpy inputs give bit-equal R, t, scores, experts,
counts and losses.  The coordinate gradient is the one exception: the C++
training loop adds each hypothesis' finite-difference terms into a cell
with an OpenMP atomic add, in whatever order the threads arrive, so two
calls of one library on the same inputs may differ in the last bits of a
cell's sum.  It is held to GRAD_ATOL (1e-6) of the largest entry: a few
float32 ulps of a cell's largest term, never more than that.
The JAX binding is pointed at a library of its own in a temporary directory
(it would otherwise build esac_cpp/libesac_cpp.so, which this file never
writes).  The port's loop is also held statistically against its own
tensor path (dsac_infer), as tests/test_backend_equivalence.py holds the
JAX pair: 1 deg / 2 cm to the ground truth, 1.5 deg / 3 cm to each other.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esac_tpu.backends.cpp as jcpp
from esac_tpu.backends.train_bridge import make_cpp_expert_losses as j_make_bridge
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu_torch import _build
from esac_tpu_torch import backends
from esac_tpu_torch.backends import cpp
from esac_tpu_torch.backends.train_bridge import make_cpp_expert_losses
from esac_tpu_torch.geometry.camera import pose_errors
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.ransac.fused_scoring import soft_inlier_scores_fused
from esac_tpu_torch.ransac.kernel import dsac_infer

F, C = 525.0, (320.0, 240.0)
REPO = pathlib.Path(__file__).resolve().parent.parent
GRAD_ATOL = 1e-6  # of max |grad_coords|: OpenMP atomic adds in thread order


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's binding, built into a temporary directory."""
    saved = (jcpp._LIB, jcpp._lib, jcpp._build_error)
    jcpp._LIB = tmp_path_factory.mktemp("jax_cpp") / "libesac_cpp.so"
    jcpp._lib = jcpp._build_error = None
    yield jcpp
    jcpp._LIB, jcpp._lib, jcpp._build_error = saved


def _rodrigues_np(rvec):
    theta = np.linalg.norm(rvec)
    K = np.array([[0, -rvec[2], rvec[1]], [rvec[2], 0, -rvec[0]], [-rvec[1], rvec[0], 0]])
    return np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta ** 2 * K @ K


def _frame(seed, height=480, width=640, f=F, noise=0.01, outlier_frac=0.3):
    """One frame on the stride-8 grid, from a numpy seed: a GT pose, cell
    coordinates back-projected at depths 1-6 m, Gaussian noise (m) and a
    fraction of cells replaced by uniform room points.  Returns coords
    (N, 3), pixels (N, 2) float32, R (3, 3), t (3,) float64."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height // 8, 0:width // 8]
    pixels = np.stack([xs.ravel() * 8 + 4.0, ys.ravel() * 8 + 4.0], 1)
    c = np.array([width / 2.0, height / 2.0])
    R = _rodrigues_np(rng.uniform(-0.3, 0.3, 3))
    t = -R @ rng.uniform([2.0, 1.5, 1.0], [4.0, 2.5, 2.0])
    depth = rng.uniform(1.0, 6.0, len(pixels))
    Y = np.concatenate([(pixels - c) / f, np.ones((len(pixels), 1))], 1) * depth[:, None]
    X = (Y - t) @ R + noise * rng.normal(size=(len(pixels), 3))
    out = rng.uniform(size=len(X)) < outlier_frac
    X[out] = rng.uniform([0, 0, 0], [6, 4, 3], (int(out.sum()), 3))
    return X.astype(np.float32), pixels.astype(np.float32), R, t


def _experts(seed, M=3, **kw):
    """M maps of one frame: map ``seed % M`` the true one, the others
    uniform room points."""
    X, px, R, t = _frame(seed, **kw)
    rng = np.random.default_rng(seed + 100)
    maps = np.stack([X if m == seed % M else
                     rng.uniform([0, 0, 0], [6, 4, 3], X.shape).astype(np.float32)
                     for m in range(M)])
    return maps, px, R, t


def _equal(got: dict, want: dict):
    """Equal dicts; ``grad_coords`` to GRAD_ATOL of its largest entry."""
    assert set(got) == set(want)
    for k in want:
        if k == "grad_coords":
            _close_grad(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _close_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_ATOL * np.abs(want).max())


def test_exports_the_jax_packages_names():
    import esac_tpu.backends as jbackends

    assert backends.__all__ == jbackends.__all__
    assert all(callable(getattr(backends, name)) for name in backends.__all__)
    assert cpp.cpp_available()


def test_library_is_built_in_the_ports_build_dir():
    """The port's library lies under esac_tpu_torch/build/, named by a hash
    of source, flags and target; esac_cpp/ is not written."""
    jax_so = REPO / "esac_cpp" / "libesac_cpp.so"
    before = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    path = _build.build_host()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("esac-host-")
    assert _build.build_host() == path  # built once, then found
    after = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    assert after == before
    assert not list(_build.BUILD_DIR.glob("*.tmp*"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*bad.cpp"):
        _build.build_host(bad)
    assert not list((tmp_path / "build").iterdir())


@pytest.mark.parametrize("seed", [1, 2])
def test_infer_equals_the_jax_binding(jax_lib, seed):
    X, px, _, _ = _frame(seed)
    kw = dict(n_hyps=128, seed=seed, return_scores=True)
    _equal(cpp.esac_infer_cpp(X, px, F, C, **kw), jax_lib.esac_infer_cpp(X, px, F, C, **kw))


def test_gated_and_multi_equal_the_jax_binding(jax_lib):
    maps, px, _, _ = _experts(4)
    gating = np.array([0.2, 0.5, 0.3], np.float32)
    kw = dict(n_hyps=192, seed=4)
    _equal(cpp.esac_infer_gated_cpp(maps, px, gating, F, C, **kw),
           jax_lib.esac_infer_gated_cpp(maps, px, gating, F, C, **kw))
    kw = dict(n_hyps_per_expert=64, seed=5)
    got = cpp.esac_infer_multi_cpp(maps, px, F, C, **kw)
    _equal(got, jax_lib.esac_infer_multi_cpp(maps, px, F, C, **kw))
    assert got["expert"] == 1


def _train_inputs(seed=6, M=2, n_hyps=24):
    maps, px, R, t = _experts(seed, M=M, height=120, width=160, f=F / 4)
    idx = np.random.default_rng(seed).integers(0, maps.shape[1], (M, n_hyps, 4), dtype=np.int32)
    return maps, px, idx, R, t


def test_train_equals_the_jax_binding(jax_lib):
    """Losses, scores and validity bit-equal; the coordinate gradient
    (analytic + finite differences, OpenMP atomic adds) to GRAD_ATOL."""
    maps, px, idx, R, t = _train_inputs(n_hyps=64)
    c = (80.0, 60.0)
    for want_grad in (True, False):
        kw = dict(want_grad=want_grad, train_refine_iters=1)
        got = cpp.esac_train_cpp(maps, px, idx, F / 4, c, R, t, **kw)
        _equal(got, jax_lib.esac_train_cpp(maps, px, idx, F / 4, c, R, t, **kw))
        assert ("grad_coords" in got) == want_grad
        if want_grad:
            assert np.abs(got["grad_coords"]).max() > 0
    assert np.abs(got["expert_losses"]).max() > 0
    with pytest.raises(ValueError, match="out of range"):
        cpp.esac_train_cpp(maps, px, idx + maps.shape[1], F / 4, c, R, t)


def test_bridge_values_and_gradients_equal_jax_grad(jax_lib):
    """sum(w * E) through the port's autograd Function and through the JAX
    bridge's custom_vjp (jax.grad), on the same injected sets: equal values,
    coordinate gradients to GRAD_ATOL (which also covers the subnormal
    products that XLA's CPU backend flushes to zero); no gradient reaches
    R_gt or t_gt."""
    maps, px, idx, R, t = _train_inputs(seed=7)
    c = (80.0, 60.0)
    w = np.array([0.7, 0.3], np.float32)
    cfg = RansacConfig(n_hyps=24, train_refine_iters=1)
    j_losses = j_make_bridge(jnp.asarray(px), F / 4, c, JRansacConfig(n_hyps=24,
                                                                      train_refine_iters=1))
    j_val, j_grad = jax.value_and_grad(
        lambda co: jnp.sum(jnp.asarray(w) * j_losses(co, jnp.asarray(R, jnp.float32),
                                                     jnp.asarray(t, jnp.float32),
                                                     jnp.asarray(idx))))(jnp.asarray(maps))
    bridge = make_cpp_expert_losses(torch.from_numpy(px), F / 4, c, cfg)
    co = torch.from_numpy(maps).requires_grad_(True)
    Rg = torch.tensor(R, dtype=torch.float32, requires_grad=True)
    E = bridge(co, Rg, torch.tensor(t, dtype=torch.float32), torch.from_numpy(idx))
    val = torch.sum(torch.from_numpy(w) * E)
    val.backward()
    assert E.dtype == torch.float32 and E.shape == (2,)
    assert float(val.detach()) == float(j_val)
    _close_grad(co.grad.numpy(), j_grad)
    assert np.abs(co.grad.numpy()).max() > 0 and Rg.grad is None
    with torch.no_grad():  # forward only: the finite-difference backward is skipped
        E2 = bridge(co, Rg, torch.tensor(t, dtype=torch.float32), torch.from_numpy(idx))
    assert torch.equal(E2, E.detach()) and not E2.requires_grad


@pytest.mark.parametrize("seed", [1, 2])
def test_cpp_and_the_ports_loop_agree_on_pose(seed):
    X, px, R, t = _frame(seed)
    got = cpp.esac_infer_cpp(X, px, F, C, n_hyps=256, seed=seed)
    out = dsac_infer(torch.Generator().manual_seed(seed), torch.from_numpy(X),
                     torch.from_numpy(px), F, torch.tensor(C), RansacConfig(n_hyps=256),
                     device="cpu")
    R_gt, t_gt = torch.tensor(R, dtype=torch.float32), torch.tensor(t, dtype=torch.float32)
    R_c = torch.tensor(got["R"], dtype=torch.float32)
    t_c = torch.tensor(got["t"], dtype=torch.float32)
    R_p = rodrigues(out["rvec"])
    for Ra, ta, Rb, tb, rot, trans in ((R_c, t_c, R_gt, t_gt, 1.0, 0.02),
                                       (R_p, out["tvec"], R_gt, t_gt, 1.0, 0.02),
                                       (R_c, t_c, R_p, out["tvec"], 1.5, 0.03)):
        r_err, t_err = pose_errors(Ra, ta, Rb, tb)
        assert float(r_err) < rot and float(t_err) < trans


def test_ports_score_of_the_cpp_winner_equals_cpps_own():
    """The kernels' scoring formula (float32) on the cpp winner against the
    C++ loop's double-precision score: rel 1e-4 (a float32 sum over 4800
    cells)."""
    X, px, _, _ = _frame(3, noise=0.02, outlier_frac=0.2)
    got = cpp.esac_infer_cpp(X, px, F, C, n_hyps=128, seed=3)
    score = soft_inlier_scores_fused(
        torch.tensor(got["R"], dtype=torch.float32)[None],
        torch.tensor(got["t"], dtype=torch.float32)[None], torch.from_numpy(X),
        torch.from_numpy(px), torch.tensor(F), torch.tensor(C), 10.0, 0.5)
    assert float(score[0]) == pytest.approx(got["score"], rel=1e-4)
    assert got["score"] > 0.5 * len(X)

