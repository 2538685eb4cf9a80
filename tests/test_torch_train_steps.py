"""The port's train steps (esac_tpu_torch.train) against the JAX package's,
on the CPU.

Each side starts from the same weights: test-size nets initialised by Flax
(or the committed test-size experts, ckpts/ckpt_expert_synth{0,1}) and
carried into the port's modules by models/convert.py; both compute in
float32.  The loss and every parameter's gradient are compared: the JAX
gradient tree is captured from the JAX step's own optimizer (a transform
that stores the gradients as its state and updates nothing) and carried
across by the same bridge, tensor by tensor; the port's stay on ``.grad``.
Adam's first update is not compared: it is about lr * sign(g), which turns
float32 rounding of tiny gradients into whole steps.

PyTorch's CPU convolutions go through oneDNN unless it is switched off,
and its float32 backward lands ~3e-3 relative off a float64 oracle on the
test-size expert where XLA's lands at 1e-7 (measured on this fixture; with
oneDNN off the port's lands at 9e-8).  These tests switch it off: they
compare the port's math, and the card runs cuDNN.

The end-to-end steps run on correspondence sets whose minimal solves agree
between the packages (on the CNN coordinates of a box room many sets are
near-degenerate, and their quartic branches flip on one ulp: ROADMAP C),
drawn with the JAX sampler and injected into both: into the port's step
as ``idx``, into the JAX dsac step through its sampler.

Tolerances: stage-1 and stage-2 losses rtol 1e-5 and gradients rtol 1e-4
(float32 convolutions summed in another order), atol 1e-4 of each
tensor's largest entry; the end-to-end steps' losses rtol 5e-3 and their
gradients, per tensor, a cosine similarity of at least 0.999 and a norm
within 1% of JAX's, the reasons of tests/test_torch_train.py (refined
poses float32-conditioned at ~1e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esac_tpu.data.datasets import SyntheticScene
from esac_tpu.data.synthetic import output_pixel_grid as j_pixel_grid
from esac_tpu.geometry.pnp import solve_pnp_minimal as j_solve
from esac_tpu.geometry.rotations import rodrigues as j_rodrigues
from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac import esac_train_loss as j_esac_train_loss
from esac_tpu.ransac.sampling import sample_correspondence_sets as j_sample
from esac_tpu.train import make_dsac_train_step as j_dsac_step
from esac_tpu.train import make_expert_reproj_train_step as j_reproj_step
from esac_tpu.train import make_expert_train_step as j_expert_step
from esac_tpu.train import make_gating_train_step as j_gating_step
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu_torch.geometry.pnp import solve_pnp_minimal
from esac_tpu_torch.models.convert import load_expert, load_gating, load_scene
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.registry.manifest import ScenePreset
from esac_tpu_torch.registry.serving import init_scene_params
from esac_tpu_torch.train import (
    make_dsac_train_step,
    make_esac_train_step,
    make_expert_reproj_train_step,
    make_expert_train_step,
    make_gating_train_step,
)

H, W, M, NH, B = 96, 128, 2, 16, 2
N = (H // 8) * (W // 8)
C = np.array([W / 2.0, H / 2.0], np.float32)


@pytest.fixture(autouse=True)
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _agreeing_sets(coords_j, coords_p, focal, key, n):
    """The first ``n`` of the JAX sampler's sets from ``key`` on one map
    whose minimal solves -- JAX's on the JAX coordinates, the port's on the
    port's -- agree to 1e-4."""
    cand = 8 * n
    pixels = np.asarray(j_pixel_grid(H, W, 8))
    idx = np.asarray(j_sample(key, cand, N))
    rv, tv = jax.vmap(lambda X, x: j_solve(X, x, focal, C, polish_iters=3))(
        jnp.asarray(coords_j)[idx], jnp.asarray(pixels)[idx])
    prv, ptv = solve_pnp_minimal(torch.as_tensor(coords_p)[idx], torch.tensor(pixels)[idx],
                                 torch.tensor(focal), torch.tensor(C), polish_iters=3)
    ok = ((np.abs(prv.numpy() - rv).max(-1) < 1e-4)
          & (np.abs(ptv.numpy() - tv).max(-1) < 1e-4))
    assert ok.sum() >= n
    return idx[ok][:n]


def _capture():
    """An optax transform whose state after an update is the gradient tree
    and whose updates are zero: the JAX step returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sgd0(*modules):
    return torch.optim.SGD([p for m in modules for p in m.parameters()], lr=0.0)


def _grads_close(got_module, grad_module, rtol=1e-4):
    for (name, p), (_, g) in zip(got_module.named_parameters(),
                                 grad_module.named_parameters()):
        want = g.detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=rtol,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def _grads_aligned(got_module, grad_module, cos=0.999, norm_rtol=1e-2):
    """Per parameter tensor: the same direction (cosine >= ``cos``) and the
    same size (norms within ``norm_rtol``)."""
    for (name, p), (_, g) in zip(got_module.named_parameters(),
                                 grad_module.named_parameters()):
        a, b = (x.detach().numpy().ravel().astype(np.float64) for x in (p.grad, g))
        assert np.isfinite(a).all(), name
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert a @ b >= cos * na * nb and nb > 0, (name, a @ b / (na * nb + 1e-30))
        assert abs(na - nb) <= norm_rtol * nb, (name, na / nb)


@pytest.fixture(scope="module")
def frames():
    scenes = [SyntheticScene(f"synth{m}", "test", n_frames=2, height=H, width=W)
              for m in range(M)]
    fr = [scenes[0][0], scenes[1][0]]
    return dict(images=np.stack([f.image for f in fr]).astype(np.float32),
                coords=np.stack([f.coords_gt for f in fr]).astype(np.float32),
                rvecs=np.stack([f.rvec for f in fr]).astype(np.float32),
                tvecs=np.stack([f.tvec for f in fr]).astype(np.float32),
                labels=np.array([f.expert for f in fr]), focal=np.float32(fr[0].focal))


def _expert_pair(seed=0):
    j_net = JExpertNet(compute_dtype=jnp.float32, **EXPERT_PRESETS["test"])
    params = j_net.init(jax.random.key(seed), jnp.zeros((1, H, W, 3)))
    net = load_expert(ExpertNet(compute_dtype=torch.float32, **EXPERT_PRESETS["test"]),
                      _np(params))
    return j_net, params, net


def _as_expert(tree):
    return load_expert(ExpertNet(compute_dtype=torch.float32, **EXPERT_PRESETS["test"]),
                       _np(tree))


def test_expert_coordinate_step_matches_jax(frames):
    j_net, params, net = _expert_pair()
    masks = (np.random.default_rng(0).uniform(size=frames["coords"].shape[:-1]) < 0.8)
    masks = masks.astype(np.float32)
    _, grads, want = j_expert_step(j_net, _capture())(
        params, _capture().init(params), frames["images"], frames["coords"], masks)
    got = make_expert_train_step(net, _sgd0(net), device="cpu")(
        frames["images"], frames["coords"], masks)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _grads_close(net, _as_expert(grads))


def test_expert_reprojection_step_matches_jax(frames):
    j_net, params, net = _expert_pair(1)
    pixels = np.asarray(j_pixel_grid(H, W, 8))
    fs = np.full(B, frames["focal"], np.float32)
    args = (frames["images"], frames["rvecs"], frames["tvecs"], fs)
    _, grads, want = j_reproj_step(j_net, _capture(), pixels, C)(
        params, _capture().init(params), *args)
    got = make_expert_reproj_train_step(net, _sgd0(net), pixels, C, device="cpu")(*args)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _grads_close(net, _as_expert(grads))


def test_gating_step_matches_jax(frames):
    j_net = JGatingNet(num_experts=M, compute_dtype=jnp.float32, **GATING_PRESETS["test"])
    params = j_net.init(jax.random.key(2), frames["images"][:1])
    net = load_gating(GatingNet(M, compute_dtype=torch.float32, **GATING_PRESETS["test"]),
                      _np(params))
    _, grads, want = j_gating_step(j_net, _capture())(
        params, _capture().init(params), frames["images"], frames["labels"])
    got = make_gating_train_step(net, _sgd0(net), device="cpu")(frames["images"],
                                                                 frames["labels"])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    grad_net = load_gating(GatingNet(M, compute_dtype=torch.float32,
                                     **GATING_PRESETS["test"]), _np(grads))
    _grads_close(net, grad_net)


@pytest.fixture(scope="module")
def experts():
    return [load_checkpoint(f"ckpts/ckpt_expert_synth{m}") for m in range(M)]


def _trained_expert(experts, m):
    params, cfg = experts[m]
    j_net = JExpertNet(scene_center=tuple(cfg["scene_center"]), compute_dtype=jnp.float32,
                       **EXPERT_PRESETS["test"])
    net = load_expert(ExpertNet(scene_center=cfg["scene_center"], compute_dtype=torch.float32,
                                **EXPERT_PRESETS["test"]), _np(params))
    return j_net, params, net


def test_dsac_step_matches_jax(frames, experts, monkeypatch):
    """Single-expert end-to-end step from the committed synth0 expert on two
    frames: loss and gradients against the JAX step, the same sets in both
    (the JAX step's sampler answers each frame's key with its table)."""
    import esac_tpu.ransac.kernel as j_kernel

    j_net, params, net = _trained_expert(experts, 0)
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    jcfg = JRansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    pixels = np.asarray(j_pixel_grid(H, W, 8))
    R_gts = np.asarray(jax.vmap(j_rodrigues)(frames["rvecs"]))
    coords_j = np.asarray(j_net.apply(params, frames["images"])).reshape(B, N, 3)
    with torch.no_grad():
        coords_p = net(torch.tensor(frames["images"])).reshape(B, N, 3).numpy()
    key = jax.random.key(3)
    frame_keys = jax.random.split(key, B)
    idx = np.stack([_agreeing_sets(coords_j[b], coords_p[b], frames["focal"],
                                   jax.random.key(20 + b), NH) for b in range(B)])
    first = jax.random.key_data(frame_keys[0])

    def sets_of(k, n_hyps, n_cells, set_size=4):
        is_first = jnp.all(jax.random.key_data(k) == first)
        return jnp.where(is_first, idx[0], idx[1])

    monkeypatch.setattr(j_kernel, "sample_correspondence_sets", sets_of)
    _, grads, want, want_aux = j_dsac_step(j_net, _capture(), jcfg, frames["focal"], C)(
        params, _capture().init(params), key, frames["images"], np.stack([pixels] * B),
        R_gts, frames["tvecs"])
    got, aux = make_dsac_train_step(net, _sgd0(net), cfg, frames["focal"], C, device="cpu")(
        3, frames["images"], pixels, R_gts, frames["tvecs"], idx=idx)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-3)
    np.testing.assert_allclose(aux["expected_loss"].numpy(), want_aux["expected_loss"],
                               rtol=5e-3)
    grad_net = load_expert(ExpertNet(compute_dtype=torch.float32, **EXPERT_PRESETS["test"]),
                           _np(grads))
    _grads_aligned(net, grad_net)


def _esac_jax_grads(experts, gating, g_params, images, R_gts, t_gts, focal, cfg, idx):
    """The dense jax-backend loss step of train_esac.py:220-258 (gating,
    stacked experts plus centers, esac_train_loss per frame with injected
    sets, mean over frames): value and gradients of (expert stack,
    gating)."""
    e_net = JExpertNet(compute_dtype=jnp.float32, **EXPERT_PRESETS["test"])
    e_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *[p for p, _ in experts])
    centers = jnp.asarray([c["scene_center"] for _, c in experts], jnp.float32)
    pixels = j_pixel_grid(H, W, 8)

    def loss_fn(ps):
        e_ps, g_p = ps
        logits = gating.apply(g_p, images)
        coords = jax.lax.map(lambda pc: e_net.apply(pc[0], images) + pc[1], (e_ps, centers))
        coords = jnp.moveaxis(coords, 0, 1).reshape(B, M, -1, 3)
        losses, _ = jax.vmap(lambda k, lg, ca, Rg, tg, ix: j_esac_train_loss(
            k, lg, ca, pixels, focal, jnp.asarray(C), Rg, tg, cfg, "dense", idx=ix))(
            jax.random.split(jax.random.key(0), B), logits, coords, R_gts, t_gts, idx)
        return jnp.mean(losses)

    return jax.value_and_grad(loss_fn)((e_stack, g_params))


def _scene(experts, g_params):
    preset = ScenePreset(height=H, width=W, num_experts=M, compute_dtype="float32",
                         gating_channels=GATING_PRESETS["test"]["channels"],
                         **EXPERT_PRESETS["test"])
    tree = {"expert": jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                   *[p for p, _ in experts]),
            "gating": _np(g_params),
            "centers": np.array([c["scene_center"] for _, c in experts], np.float32),
            "f": np.float32(525.0 * W / 640.0), "c": C}
    scene = load_scene(init_scene_params(preset, device="cpu"), tree)
    scene["expert"].train()
    scene["gating"].train()
    return scene


def test_esac_step_matches_jax(frames, experts):
    """Gating + 2 committed experts, dense estimator, "pallas" scoring: the
    loss and the gradients of every expert and of the gating net against
    the JAX composition of train_esac.py's step, the sets injected."""
    gating = JGatingNet(num_experts=M, compute_dtype=jnp.float32, **GATING_PRESETS["test"])
    g_params = gating.init(jax.random.key(7), frames["images"][:1])
    R_gts = np.asarray(jax.vmap(j_rodrigues)(frames["rvecs"]))
    cfg = RansacConfig(n_hyps=NH, train_refine_iters=1, scoring_impl="pallas")
    scene = _scene(experts, g_params)
    with torch.no_grad():
        coords_p = torch.stack([net(torch.tensor(frames["images"]))
                                for net in scene["expert"]], 1).reshape(B, M, N, 3)
        coords_p = (coords_p + scene["centers"][None, :, None]).numpy()
    idx = np.empty((B, M, NH, 4), np.int64)
    for m in range(M):
        j_net, params, _ = _trained_expert(experts, m)
        coords_j = np.asarray(j_net.apply(params, frames["images"])).reshape(B, N, 3)
        for b in range(B):
            idx[b, m] = _agreeing_sets(coords_j[b], coords_p[b, m], frames["focal"],
                                       jax.random.key(30 + 2 * m + b), NH)
    want, (e_grads, g_grads) = _esac_jax_grads(
        experts, gating, g_params, frames["images"], R_gts, frames["tvecs"],
        frames["focal"], JRansacConfig(n_hyps=NH, train_refine_iters=1), idx)
    opt = _sgd0(scene["expert"], scene["gating"])
    step = make_esac_train_step(scene, opt, cfg, j_pixel_grid(H, W, 8), clip_norm=math.inf,
                                device="cpu")
    got = step(0, frames["images"], R_gts, frames["tvecs"], idx=idx)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-3)
    for m in range(M):
        grad_net = load_expert(ExpertNet(compute_dtype=torch.float32,
                                         **EXPERT_PRESETS["test"]),
                               jax.tree.map(lambda x, m=m: np.asarray(x)[m], e_grads))
        _grads_aligned(scene["expert"][m], grad_net)
    _grads_aligned(scene["gating"], load_gating(
        GatingNet(M, compute_dtype=torch.float32, **GATING_PRESETS["test"]), _np(g_grads)))


@pytest.mark.parametrize("clip", [0.05, math.inf])
def test_adam_after_clipping_matches_optax(clip):
    """The e2e step's optimizer: torch.nn.utils.clip_grad_norm_ then
    torch.optim.Adam, against optax.chain(clip_by_global_norm, adam) on
    fixed gradients, over two steps (the clip active, and a no-op)."""
    rng = np.random.default_rng(5)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 0.1 for p in params]
             for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-2))
    j_params, state = list(params), opt.init(params)
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    t_opt = torch.optim.Adam(ps, lr=1e-2)
    for g in grads:
        upd, state = opt.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, gi in zip(ps, g):
            p.grad = torch.tensor(gi)
        torch.nn.utils.clip_grad_norm_(ps, clip)
        t_opt.step()
    for p, want in zip(ps, j_params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_esac_steps_lower_the_loss(frames, experts):
    """Four steps on one batch with one step seed (the same hypotheses every
    step), at train_esac.py's fine-tune recipe (Adam, lr 3e-6, clip 1.0),
    lower the expected pose loss at every step, and every step's gradients
    are finite (tests/test_end_to_end.py:101); every step reports its
    stages to the timing hook, in the order it runs them."""
    gating = JGatingNet(num_experts=M, compute_dtype=jnp.float32, **GATING_PRESETS["test"])
    scene = _scene(experts, gating.init(jax.random.key(7), frames["images"][:1]))
    params = list(scene["expert"].parameters()) + list(scene["gating"].parameters())
    step = make_esac_train_step(scene, torch.optim.Adam(params, lr=3e-6),
                                RansacConfig(n_hyps=NH, train_refine_iters=1,
                                             scoring_impl="pallas"),
                                j_pixel_grid(H, W, 8), device="cpu")
    R_gts = np.asarray(jax.vmap(j_rodrigues)(frames["rvecs"]))
    losses = []
    for _ in range(4):
        stages = []
        losses.append(float(step(11, frames["images"], R_gts, frames["tvecs"],
                                 on_stage=stages.append)))
        assert all(torch.isfinite(p.grad).all() for p in params)
        assert stages == ["cnn_forward", "hypotheses", "scoring_forward", "refine_and_loss",
                          "backward", "optimizer"]
    assert np.isfinite(losses).all() and (np.diff(losses) < 0).all(), losses
