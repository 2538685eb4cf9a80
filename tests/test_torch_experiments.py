"""The port's counterparts of the stage profile, the generalization
experiment and the routed-training bench (esac_tpu_torch.experiments.
{profile_stages,generalization}, esac_tpu_torch.tools.routed_train_bench)
against the JAX functions the root scripts call, at small sizes.

- profile_stages: config #1's frames (the JAX package's
  ``make_correspondence_frame`` from seeds, 1 cm noise, 30% outliers) at
  2 frames x 16 hypotheses x 4800 cells, the correspondence sets injected
  (``idx``, drawn with numpy) and ``score_cells`` 0, against the JAX
  stages: every impl's scores of the port's hypotheses against JAX's
  scores of the same hypotheses (rtol 1e-5, atol 1e-3 as in
  test_torch_scoring.py), the winners exactly, the refined winners and the
  whole ``dsac_infer`` at 1e-4.  The hypotheses themselves: the winners'
  at 1e-4, and at least 3/4 of all within 1e-2 -- float32 P3P + polish on
  near-degenerate minimal sets of noisy, outlier-ridden cells parts the two
  packages by up to ~4e-2 (ROADMAP.md §C).  Its line holds the JAX
  script's keys (no "pallas" off the card).
- generalization: the renders equal JAX's ``render_box_scene`` off the
  room's seams; the novel-view evaluation of one fixed network (the
  committed ``ckpts/ckpt_expert_synth0``, carried across by
  ``models.convert``) with injected sets matches the JAX evaluation's pose
  errors within 1e-3 rad and 1e-3 m; the printed line parses.
- routed_train_bench at M = 8 over 2 gloo ranks, the loss clamp raised so
  that the loss does not saturate, JAX's sets injected: its dense and
  routed losses agree (rtol 1e-4) and equal ``esac_tpu.parallel.
  make_sharded_esac_loss`` on the same weights, its gradients follow
  JAX's, and its ``structural`` block follows the JAX script's formulas.
"""

import contextlib
import io
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.data import make_correspondence_frame as j_frame
from esac_tpu.data.synthetic import render_box_scene as j_render
from esac_tpu.geometry import pose_errors as j_pose_errors
from esac_tpu.geometry import rodrigues as j_rodrigues
from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.parallel import make_sharded_esac_loss as j_sharded_loss
from esac_tpu.parallel.mesh import make_mesh as j_make_mesh
from esac_tpu.ransac import RansacConfig as JRansacConfig
from esac_tpu.ransac import kernel as j_kernel
from esac_tpu.ransac.refine import refine_soft_inliers as j_refine
from esac_tpu.ransac.sampling import sample_correspondence_sets as j_sample_sets
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu_torch.experiments import generalization as gen
from esac_tpu_torch.experiments import profile_stages as ps
from esac_tpu_torch.models.convert import load_expert, load_gating
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.tools import routed_train_bench as rtb

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    """Two intra-op threads a case: under the tier-1 run's 6 loaded
    workers, 8 threads each oversubscribe the host (these cases check
    values, not speed); restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


SCORE_TOL = dict(rtol=1e-5, atol=1e-3)
POSE_ATOL = 1e-4
B, NH = 2, 16
# The JAX script's keys (experiments/profile_stages.py:96-109, :113).
PROFILE_KEYS = {"sample_solve_ms", "score_ms_errmap", "score_ms_fused", "score_ms_pallas",
                "refine_ms", "full_ms", "batch", "n_hyps", "device_kind", "platform",
                "score_ms"}


def _jax_dsac_infer(monkeypatch, keys, coords, sets, pixels, f, c, cfg):
    """JAX's ``dsac_infer`` on each frame (vmapped, one trace), its sampler
    returning that frame's ``sets``: the function under its jit, traced with
    the sets as an argument (patching the sampler of the jitted function
    would keep the first call's sets as a constant of its trace)."""
    def one(key, co, idx):
        monkeypatch.setattr(j_kernel, "sample_correspondence_sets", lambda k, n, N: idx)
        return j_kernel.dsac_infer.__wrapped__(key, co, pixels, f, c, cfg)

    return jax.jit(jax.vmap(one))(keys, jnp.asarray(coords), jnp.asarray(sets))


def _stdout_line(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if len(lines) == 1 else json.loads(buf.getvalue())


# ------------------------------------------------------------ profile_stages


@pytest.fixture(scope="module")
def stage_case():
    frames = [j_frame(jax.random.key(b), noise=0.01, outlier_frac=0.3) for b in range(B)]
    coords = np.stack([np.asarray(f["coords"]) for f in frames])
    pixels = np.asarray(frames[0]["pixels"])
    N = coords.shape[1]
    rng = np.random.default_rng(0)
    idx = np.stack([[rng.choice(N, 4, replace=False) for _ in range(NH)]
                    for _ in range(B)]).astype(np.int32)
    inp = {"coords": torch.from_numpy(coords), "pixels": torch.from_numpy(pixels),
           "f": torch.full((B,), 525.0), "c": torch.tensor([320.0, 240.0])}
    line, out = ps.profile(CPU, B, NH, repeats=1, inp=inp, idx=torch.from_numpy(idx))
    return dict(coords=coords, pixels=pixels, idx=idx, line=line, out=out)


def _jax_stages(case, monkeypatch):
    cfg = JRansacConfig(n_hyps=NH)
    f, c = jnp.float32(525.0), jnp.asarray([320.0, 240.0])
    res = {"rvecs": [], "tvecs": [], "scores_errmap": [], "scores_fused": [], "best": [],
           "refined": [], "full": []}
    for b in range(B):
        co, px = jnp.asarray(case["coords"][b]), jnp.asarray(case["pixels"])
        rv, tv = j_kernel.generate_hypotheses(None, co, px, f, c, cfg,
                                              idx=jnp.asarray(case["idx"][b]))
        res["rvecs"].append(rv)
        res["tvecs"].append(tv)
        port_rv = jnp.asarray(case["out"]["rvecs"][b].numpy())
        port_tv = jnp.asarray(case["out"]["tvecs"][b].numpy())
        for impl in ("errmap", "fused"):
            icfg = JRansacConfig(n_hyps=NH, scoring_impl=impl)
            res[f"scores_{impl}"].append(j_kernel._score_hypotheses(
                jax.random.key(1), port_rv, port_tv, co, px, f, c, icfg))
        best = int(jnp.argmax(j_kernel._score_hypotheses(jax.random.key(1), rv, tv, co, px,
                                                         f, c, cfg)))
        res["best"].append(best)
        res["refined"].append(j_refine(rv[best], tv[best], co, px, f, c, cfg.tau, cfg.beta,
                                       iters=cfg.refine_iters))
    full = _jax_dsac_infer(monkeypatch, jax.random.split(jax.random.key(2), B),
                           case["coords"], case["idx"], jnp.asarray(case["pixels"]), f, c, cfg)
    res["full"] = [{k: v[b] for k, v in full.items()} for b in range(B)]
    return res


def test_profile_stages_matches_the_jax_stages(stage_case, monkeypatch):
    want = _jax_stages(stage_case, monkeypatch)
    got = stage_case["out"]
    hyps = np.concatenate([got["rvecs"].numpy(), got["tvecs"].numpy()], -1)
    want_hyps = np.concatenate([np.stack(want["rvecs"]), np.stack(want["tvecs"])], -1)
    off = np.abs(hyps - want_hyps).max(-1)
    assert (off <= 1e-2).mean() >= 0.75, off
    for impl in ("errmap", "fused"):
        w = np.stack(want[f"scores_{impl}"])
        np.testing.assert_allclose(got[f"scores_{impl}"].numpy(), w, **SCORE_TOL)
        top2 = np.sort(w, -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1.0).all()  # no near tie in the fixture
    np.testing.assert_array_equal(got["best"].numpy(), want["best"])
    assert (off[np.arange(B), want["best"]] <= POSE_ATOL).all()
    for k, i in (("rvec", 0), ("tvec", 1)):
        np.testing.assert_allclose(got["refined"][i].numpy(),
                                   np.stack([r[i] for r in want["refined"]]), atol=POSE_ATOL)
        np.testing.assert_allclose(got["full"][k].numpy(),
                                   np.stack([r[k] for r in want["full"]]), atol=POSE_ATOL)
    np.testing.assert_array_equal(got["full"]["best"].numpy(),
                                  [int(r["best"]) for r in want["full"]])


def test_profile_stages_line_holds_the_jax_keys(stage_case):
    line = stage_case["line"]
    assert set(line) == PROFILE_KEYS - {"score_ms_pallas"} | {"device"}
    assert line["platform"] == "cpu" and line["device_kind"] == "cpu"
    assert line["device"]["name"] is None
    assert (line["batch"], line["n_hyps"]) == (B, NH)
    assert line["score_ms"] == line["score_ms_errmap"]
    assert all(line[k] > 0 for k in PROFILE_KEYS - {"score_ms_pallas", "batch", "n_hyps",
                                                     "device_kind", "platform"})
    cli = _stdout_line(ps.main, ["--cpu", "--batch", "2", "--n-hyps", "8", "--repeats", "1"])
    assert set(cli) == set(line) and cli["n_hyps"] == 8


# ------------------------------------------------------------ generalization


def _seam_share(got, want, tol=1e-4):
    """The share of entries off by more than ``tol``: renders differ only
    on the room's seams, where a ray meets two walls at once."""
    return float((np.abs(got - want) > tol).mean())


def test_generalization_renders_equal_jax():
    rv, tv = gen.random_poses_in_box(gen._generator(gen.VIEW_SEED, CPU), 4)
    got = gen.render(rv, tv)
    want = jax.vmap(lambda r, t: j_render(r, t, gen.H, gen.W, gen.FOCAL, gen.CENTER, 8))(
        jnp.asarray(rv.numpy()), jnp.asarray(tv.numpy()))
    assert _seam_share(got["image"].numpy(), np.asarray(want["image"])) <= 1e-3
    assert _seam_share(got["coords"].numpy().reshape(4, -1, 3),
                       np.asarray(want["coords_gt"])) <= 1e-3
    np.testing.assert_array_equal(got["pixels"].numpy(), np.asarray(want["pixels"][0]))


def test_generalization_evaluation_matches_jax(monkeypatch):
    params, cfg = load_checkpoint("ckpts/ckpt_expert_synth0")
    center = tuple(cfg["scene_center"])
    net = load_expert(ExpertNet(**{**gen.NET, "scene_center": center}), params).eval()
    rng = np.random.default_rng(3)
    n_cells = (gen.H // 8) * (gen.W // 8)
    idx = np.stack([[rng.choice(n_cells, 4, replace=False) for _ in range(64)]
                    for _ in range(gen.N_VIEWS)]).astype(np.int64)
    got = gen.evaluate(net, CPU, idx=torch.from_numpy(idx))

    jnet = JExpertNet(scene_center=center, stem_channels=(16, 32, 64), head_channels=64,
                      head_depth=2, compute_dtype=jnp.float32)
    rv, tv = jnp.asarray(got["rvec"].numpy()), jnp.asarray(got["tvec"].numpy())
    views = jax.vmap(lambda r, t: j_render(r, t, gen.H, gen.W, gen.FOCAL, gen.CENTER, 8))(
        rv, tv)
    pred = jnet.apply(params, views["image"]).reshape(gen.N_VIEWS, -1, 3)
    jcfg = JRansacConfig(n_hyps=64, refine_iters=6)
    out = _jax_dsac_infer(monkeypatch, jax.random.split(jax.random.key(200), gen.N_VIEWS),
                          pred, idx.astype(np.int32), views["pixels"][0],
                          jnp.float32(gen.FOCAL), jnp.asarray(gen.CENTER), jcfg)
    r, t = jax.vmap(j_pose_errors)(jax.vmap(j_rodrigues)(out["rvec"]), out["tvec"],
                                   jax.vmap(j_rodrigues)(rv), tv)
    rot, trans = [float(x) for x in r], [float(x) for x in t]
    np.testing.assert_allclose(got["rot_deg"], rot, atol=math.degrees(1e-3))
    np.testing.assert_allclose(got["trans_m"], trans, atol=1e-3)
    assert got["ok"] == sum(int(r < 5 and t < 0.05) for r, t in zip(rot, trans))


def test_generalization_prints_a_line_that_parses():
    line = _stdout_line(gen.main, ["16", "noaug", "20", "--cpu"])
    assert (line["frames"], line["aug"], line["iters"]) == (16, False, 20)
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert re.fullmatch(r"\d+/16", line["5cm5deg"])
    assert re.fullmatch(r"frames=16 aug=False iters=20: train_loss=\d+\.\d{3} novel coord "
                        r"med=\d+\.\dcm pose med=\d+\.\d{2}deg/\d+\.\dcm 5cm5deg=\d+/16 "
                        r"\(\d+s\)", line["line"])
    assert all(math.isfinite(line[k]) for k in ("train_loss", "coord_med_cm", "pose_med_deg",
                                                "pose_med_cm"))


# ------------------------------------------------------ routed_train_bench


M_SMALL, RANKS = 8, 2


def _numpy_params(module, rng, lead=()):
    """A Flax module's params from numpy: kernels normal / sqrt(fan-in),
    biases 0 (a Flax init traced per expert takes tens of seconds here)."""
    def fill(s):
        shape = lead + tuple(s.shape)
        if len(s.shape) == 1:
            return np.zeros(shape, np.float32)
        return (rng.normal(size=shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    img = jnp.zeros((1, rtb.H, rtb.W, 3))
    return jax.tree.map(fill, jax.eval_shape(lambda: module.init(jax.random.key(0), img)))


def _jax_sets(key, n_frames, experts, n_hyps, n_cells):
    """The sets ``make_sharded_esac_loss`` draws from ``key`` on a mesh of
    one data shard (both policies draw the same): per frame
    split(fold_in(key, 0), B), then esac_train_loss's k_hyp, then one key
    per global expert (score_cells 0: no subsample split)."""
    frames = jax.random.split(jax.random.fold_in(key, 0), n_frames)
    return np.stack([np.asarray(jax.vmap(
        lambda k: j_sample_sets(k, n_hyps, n_cells))(
            jax.random.split(jax.random.split(k)[0], experts))) for k in frames])


def test_routed_train_bench_losses_agree_and_equal_jax(tmp_path):
    """One set of weights made with numpy, carried across; the sharpened
    gate must put its mass inside capacity 2 for the two policies to
    compute the same loss (the JAX script's condition), which the fixture
    checks first.  The JAX script's clamp saturates at random weights
    (both losses read exactly 100, and the gradients are zero), so both
    sides run with the clamp at 1e6 and the test asserts the loss is under
    it.  JAX's sharded loss draws its sets from its key; the same sets go
    into the port through the bench's ``inputs``.

    Both policies' losses are held to JAX's dense sharded loss at rtol 1e-4
    (with the mass inside capacity JAX's routed loss is the dense one; its
    compile is left out for time).  Every expert's gradients, of both
    policies, are held against JAX's dense gradients (with the mass inside
    capacity they are the routed ones too) within 1e-2 of each leaf's norm:
    float32 P3P on random coordinates parts the packages by up to 3e-3
    there, as much as it parts JAX's own two policies.  The gate's
    gradients are held for the dense policy, elementwise at rtol 1e-3: at
    the sharpened gate they are float32 rounding of a softmax at 1 - 1e-7
    (the exact logit gradient is below the spacing of the loss), so only
    the same order of sums reproduces them, and the routed policy sums per
    rank: its gate gradients are held to the dense ones' direction (cosine
    over 0.99 a leaf; 0.9994 or more measured), not their length."""
    clamp = 1e6
    expert = JExpertNet(scene_center=(0.0, 0.0, 0.0), stem_channels=(8, 16, 32),
                        head_channels=32, head_depth=1, compute_dtype=jnp.float32)
    gating = JGatingNet(num_experts=M_SMALL, channels=(8, 16), compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    e_params = _numpy_params(expert, rng, (M_SMALL,))
    g_params = _numpy_params(gating, rng)
    cfg = JRansacConfig(n_hyps=16, refine_iters=2, train_refine_iters=1, loss_clamp=clamp)
    key = jax.random.key(3)  # the bench's last timed step's seed at repeats=1
    cells = (rtb.H // 8) * (rtb.W // 8)
    idx = _jax_sets(key, rtb.B, M_SMALL, cfg.n_hyps, cells)

    def t_expert():
        return ExpertNet(stem_channels=(8, 16, 32), head_channels=32, head_depth=1,
                         compute_dtype=torch.float32)

    def t_gating():
        return GatingNet(M_SMALL, (8, 16), compute_dtype=torch.float32)

    state = {"experts": [load_expert(t_expert(), jax.tree.map(lambda x: x[m], e_params))
                         .state_dict() for m in range(M_SMALL)],
             "gating": load_gating(t_gating(), g_params).state_dict(),
             "idx": torch.as_tensor(idx)}
    torch.save(state, tmp_path / "inputs.pt")
    doc = rtb.measure(CPU, ranks=RANKS, experts=M_SMALL, repeats=1, loss_clamp=clamp,
                      inputs=str(tmp_path / "inputs.pt"), grads_out=str(tmp_path / "grads.pt"))
    got_grads = torch.load(tmp_path / "grads.pt")

    g_sharp = jax.tree_util.tree_map_with_path(
        lambda path, x: x * rtb.GATE_SHARPEN if any(
            getattr(k, "key", None) == "Dense_1" for k in path) else x, g_params)
    mesh = j_make_mesh(n_data=1, n_expert=RANKS, devices=jax.devices()[:RANKS])
    from esac_tpu.data import output_pixel_grid

    pixels = output_pixel_grid(rtb.H, rtb.W, 8)
    f, c = jnp.float32(60.0), jnp.asarray([rtb.W / 2.0, rtb.H / 2.0])
    images = jnp.linspace(0.0, 1.0, rtb.B * rtb.H * rtb.W * 3).reshape(rtb.B, rtb.H, rtb.W, 3)
    mass = np.sort(np.asarray(jax.nn.softmax(gating.apply(g_sharp, images), -1)), -1)
    assert (mass[:, -rtb.CAP:].sum(-1) > 1 - 1e-6).all(), mass
    R = jnp.tile(j_rodrigues(jnp.asarray([0.1, -0.05, 0.02]))[None], (rtb.B, 1, 1))
    t = jnp.tile(jnp.asarray([-3.0, -2.0, 3.0]), (rtb.B, 1))
    with mesh:
        loss = j_sharded_loss(mesh, expert, gating, e_params, g_sharp, pixels, f, c, cfg, "dense")
        want, (ge, gg) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            e_params, g_sharp, images, R, t, key)

    got = doc["loss"]
    assert doc["loss_clamp"] == clamp
    assert doc["loss_saturated"] == {"dense": False, "routed": False}
    assert 0.0 < got["dense"] < clamp / 10, got  # far from the clamp, so it has gradients
    assert math.isclose(got["dense"], got["routed"], rel_tol=1e-4)
    ref = {m: {k: v.detach().numpy() for k, v in load_expert(
        t_expert(), jax.tree.map(lambda x: x[m], ge)).named_parameters()} for m in range(M_SMALL)}
    # A leaf's floor is 1e-4 of its largest norm over the experts (the
    # unselected experts' gradients carry a vanishing gate mass).
    floor = {k: 1e-4 * max(np.linalg.norm(ref[m][k]) for m in ref) for k in ref[0]}
    assert all(v > 0 for v in floor.values()), floor
    for name in ("dense", "routed"):
        assert math.isclose(got[name], float(want), rel_tol=1e-4), (got, want)
        assert sorted(got_grads[name]["experts"]) == list(range(M_SMALL))
        for m, leaves in ref.items():
            have = got_grads[name]["experts"][m]
            assert set(have) == set(leaves), m
            for k, r in leaves.items():
                err = np.linalg.norm(have[k].numpy() - r)
                assert err <= 1e-2 * np.linalg.norm(r) + floor[k], (name, m, k, err)
    gate = {k: v.detach().numpy() for k, v in load_gating(t_gating(), gg).named_parameters()}
    for k, r in gate.items():
        np.testing.assert_allclose(got_grads["dense"]["gating"][k].numpy(), r, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(r).max()), err_msg=k)
        routed = got_grads["routed"]["gating"][k].numpy().ravel()
        cos = routed @ r.ravel() / (np.linalg.norm(routed) * np.linalg.norm(r) + 1e-30)
        assert cos > 0.99, (k, cos)
    assert {"config", "dense_step_ms", "routed_step_ms", "routed_over_dense", "loss",
            "structural", "note", "loss_clamp", "loss_saturated", "ranks", "platform",
            "device"} == set(doc)
    assert doc["structural"] == {
        "expert_forwards_per_frame": {"dense": M_SMALL, "routed": RANKS * rtb.CAP},
        "ep_collective_bytes_per_frame": {"dense": M_SMALL * cells * 3 * 4, "routed": 4}}
    assert doc["ranks"] == RANKS and doc["platform"] == "cpu"
    assert doc["routed_over_dense"] == doc["routed_step_ms"] / doc["dense_step_ms"]
