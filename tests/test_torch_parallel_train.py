"""The port's expert-parallel training (esac_tpu_torch.parallel.
train_sharded) on 4 gloo CPU ranks against its single-device loss, and the
scripts' --sharded runs against their unsharded runs.

One group of 4 ranks is spawned for the loss cases (tests/
torch_parallel_cases.py); the scripts spawn their own 2 ranks.  The
fixtures are tests/test_parallel.py's training ones: trainable "experts"
whose output is their coordinate map, a gating net whose parameters are
its logits plus a fixed mask, 8 experts, 2 frames.

- The sharded loss equals the single-device ``esac_train_loss_frames``
  mean within rtol 1e-6 (the same float32 terms summed in another order),
  and on every rank the gradients of its local experts and of the gating
  logits equal the single-device ones within rtol 1e-5, atol 1e-6 of the
  largest entry; on the 1x4 and 2x2 meshes.  Routed training runs its
  problems through calls of another shape than dense's (b x capacity maps,
  not b x M), so the float32 backward adds in another order: its
  gradients are held to atol 1e-5 of the largest entry.
- The capacity rules of tests/test_parallel.py:508, :586 and :603.
- ``train_esac --sharded --cpu --devices 2`` (3 experts padded to 4)
  prints the unsharded run's losses and saves its experts and gating
  within rtol 1e-5;
  ``test_esac --sharded --cpu --devices 2`` reports the unsharded
  evaluation's winners, errors and percentages.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from esac_tpu.data import CAMERA_F, make_correspondence_frame
from esac_tpu_torch.geometry.rotations import rodrigues
from esac_tpu_torch.parallel import make_sharded_esac_loss, spawn_ranks
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.scripts import test_esac, train_esac, train_expert, train_gating
from esac_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
M = 8
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
FRAME_KW = dict(height=120, width=160, f=CAMERA_F / 4.0, c=(80.0, 60.0))
TRAIN_CFG = dict(n_hyps=8, refine_iters=2, train_refine_iters=1, scoring_impl="pallas")


def _inputs():
    key = jax.random.key(11)
    frame = make_correspondence_frame(key, noise=0.01, **FRAME_KW)
    n = frame["coords"].shape[0]
    maps = np.stack([np.asarray(frame["coords"]) if m == 3 else
                     np.asarray(jax.random.uniform(jax.random.fold_in(key, m), (n, 3),
                                                   maxval=5.0)) for m in range(M)])
    R = rodrigues(torch.as_tensor(np.array(frame["rvec"]))).numpy()
    covered = np.full(M, -1e9, np.float32)
    covered[[1, 2, 5, 6]] = 0.0  # one expert of each 1x4 rank's two
    return {"train": dict(
        maps=maps.astype(np.float32), pixels=np.asarray(frame["pixels"]),
        f=np.float32(CAMERA_F / 4.0), c=np.array([80.0, 60.0], np.float32),
        R=np.stack([R, R]), t=np.stack([np.asarray(frame["tvec"])] * 2),
        cases={
            "dense": dict(mask=np.zeros(M, np.float32), cfg=TRAIN_CFG, meshes=["1x4", "2x2"],
                          capacities=[None]),
            "covered": dict(mask=covered, cfg=dict(TRAIN_CFG, loss_clamp=1e6),
                            meshes=["1x4"], capacities=[None, 1]),
            "spread": dict(mask=np.zeros(M, np.float32), cfg=TRAIN_CFG, meshes=["1x4"],
                           capacities=[None, 1]),
        })}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_train")
    torch.save(_inputs(), d / "inputs.pt")
    spawn_ranks(cases.run_training, WORLD, args=(str(d),), backend="gloo", device="cpu")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _assert_grads(got, ref, lo, m, what, atol=1e-6):
    g_experts, g_gating = got
    r_experts, r_gating = ref
    scale = max(float(np.abs(r_gating).max()), 1e-12)
    np.testing.assert_allclose(g_gating, r_gating, rtol=GRAD_RTOL, atol=atol * scale,
                               err_msg=f"{what}: gating")
    scale = max(float(np.abs(np.stack(r_experts)).max()), 1e-12)
    for i in range(lo, lo + m):
        want = r_experts[i]
        have = g_experts[i] if g_experts[i] is not None else np.zeros_like(want)
        np.testing.assert_allclose(have, want, rtol=GRAD_RTOL, atol=atol * scale,
                                   err_msg=f"{what}: expert {i}")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_dense_loss_and_gradients_match_single_device(world, mesh):
    ref_loss, ref_grads = world[0][("dense", "ref")]
    for r in range(WORLD):
        loss, grads, lo, m = world[r][("dense", mesh, None)]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        _assert_grads(grads, ref_grads, lo, m, f"rank {r}")
        assert m == {"1x4": 2, "2x2": 4}[mesh]
        assert np.any(grads[1] != 0)
        assert any(np.any(grads[0][i] != 0) for i in range(lo, lo + m)
                   if grads[0][i] is not None)


def test_routed_training_matches_dense_when_capacity_covers_mass(world):
    """tests/test_parallel.py:508: the gating mass on one expert per rank
    (the others at exactly zero), capacity 1: routed training is the dense
    loss and gradients; unselected experts' gradients are exactly zero."""
    ref_loss, ref_grads = world[0][("covered", "ref")]
    for r in range(WORLD):
        for capacity in (None, 1):
            loss, grads, lo, m = world[r][("covered", "1x4", capacity)]
            np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
            _assert_grads(grads, ref_grads, lo, m, f"rank {r} capacity {capacity}",
                          atol=1e-6 if capacity is None else 1e-5)
        g_experts = world[r][("covered", "1x4", 1)][1][0]
        for i in range(lo, lo + m):
            if i in (1, 2, 5, 6):
                assert np.any(g_experts[i] != 0)
            else:
                assert g_experts[i] is None or not np.any(g_experts[i])
    assert all(not np.any(ref_grads[0][i]) for i in (0, 3, 4, 7))


def test_routed_training_truncates_spread_mass(world):
    """tests/test_parallel.py:586: uniform mass, capacity 1 of 2 local
    experts: the routed loss is biased low, half-ish of dense."""
    for r in range(WORLD):
        dense = world[r][("spread", "1x4", None)][0]
        routed = world[r][("spread", "1x4", 1)][0]
        np.testing.assert_allclose(dense, world[0][("spread", "ref")][0], rtol=LOSS_RTOL)
        assert routed < dense and 0.3 < routed / dense < 0.7


def test_routed_training_requires_dense_mode():
    """tests/test_parallel.py:603."""
    with pytest.raises(ValueError, match="dense"):
        make_sharded_esac_loss(None, [], None, torch.zeros((8, 3)), torch.zeros((300, 2)),
                               1.0, torch.zeros(2), RansacConfig(), mode="sampled", capacity=1,
                               device="cpu")


# ------------------------------------------------------------------ scripts

COMMON = ["--cpu", "--size", "test", "--batch", "2", "--frames", "4", "--learningrate", "1e-3"]
SCENES = ["synth0", "synth1", "synth2"]


def _run(module, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return buf.getvalue()


def _run_sharded(name, argv):
    """A --sharded run in a fresh interpreter (its 2 ranks print to it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    res = subprocess.run([sys.executable, "-m", f"esac_tpu_torch.scripts.{name}", *argv],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_scripts")
    for i, s in enumerate(SCENES):
        _run(train_expert, [s, *COMMON, "--iterations", "2", "--output", str(d / f"e{i}")])
    _run(train_gating, [*SCENES, *COMMON, "--iterations", "2", "--output", str(d / "g")])
    return d, ["--experts", *(str(d / f"e{i}") for i in range(3)), "--gating", str(d / "g")]


def _train_argv(ckpts):
    # Unclamped losses: the clamp would flatten these weak experts' losses
    # and zero every gradient.
    return [*SCENES, *COMMON, "--iterations", "2", "--hypotheses", "16", "--scoring-impl",
            "pallas", "--loss-clamp", "1e6", *ckpts]


@pytest.fixture(scope="module")
def trained(stages):
    """train_esac unsharded (in process) and --sharded over 2 spawned ranks
    on the same checkpoints; returns both outputs."""
    d, ckpts = stages
    argv = _train_argv(ckpts)
    plain = _run(train_esac, [*argv, "--output", str(d / "plain")])
    out = _run_sharded("train_esac", [*argv, "--sharded", "--devices", "2",
                                      "--output", str(d / "sharded")])
    return plain, out


def test_train_esac_sharded_equals_unsharded(stages, trained):
    d, _ = stages
    plain, out = trained
    assert "sharded training: 2 devices, M=3 (+1 pad), capacity=dense" in out
    assert out.count("saved ") == 1  # rank 0 alone writes

    def losses(text):
        return [ln.split("E[pose loss]")[1].split()[0] for ln in text.splitlines()
                if "E[pose loss]" in ln]

    assert losses(out) == losses(plain) and len(losses(plain)) == 3
    for name in ("expert0", "expert1", "expert2", "gating"):
        want, _ = load_checkpoint(d / f"plain_{name}")
        got, _ = load_checkpoint(d / f"sharded_{name}")
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                       atol=1e-6, err_msg=f"{name}.{k}")


def test_train_esac_sharded_state_and_resume(stages, trained):
    """Rank 0's train state is the unsharded run's: every expert's Adam
    moments and steps gathered from its rank, then gating's (3 experts + 1
    pad sharded, 3 unsharded), within the losses' tolerances.  A sharded
    run stopped after one iteration and resumed (each rank loading its
    experts' slice of the state) ends bit-equal to the uninterrupted one."""
    d, ckpts = stages
    plain, sharded = (load_train_state(d / f"{n}_state")[1] for n in ("plain", "sharded"))
    n_plain = len(plain["param_groups"][0]["params"])
    k = len(sharded["param_groups"][0]["params"]) - n_plain  # one expert's parameters
    pairs = [(i, i) for i in range(3 * k)] + [(i, i + k) for i in range(3 * k, n_plain)]
    for i, j in pairs:
        want, got = plain["state"][i], sharded["state"][j]
        assert float(got["step"]) == float(want["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            w = want[key].numpy()
            np.testing.assert_allclose(got[key].numpy(), w, rtol=GRAD_RTOL,
                                       atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
                                       err_msg=f"param {i}: {key}")
    assert sharded["param_groups"][0]["lr"] == plain["param_groups"][0]["lr"]

    argv = [*_train_argv(ckpts), "--sharded", "--devices", "2", "--output", str(d / "resumed")]
    _run_sharded("train_esac", [*argv, "--stop-after", "1"])
    out = _run_sharded("train_esac", [*argv, "--resume"])
    assert "at iteration 1" in out
    for name in ("expert0", "expert1", "expert2", "gating"):
        want, _ = load_checkpoint(d / f"sharded_{name}")
        got, _ = load_checkpoint(d / f"resumed_{name}")
        for key in want:
            assert torch.equal(got[key], want[key]), f"{name}.{key}"


def test_test_esac_sharded_equals_unsharded(stages):
    d, ckpts = stages
    argv = [*SCENES, "--cpu", "--size", "test", "--frames", "4", "--hypotheses", "16",
            "--limit", "3", "--eval-batch", "4", "--scoring-impl", "pallas", *ckpts]
    _run(test_esac, [*argv, "--json", str(d / "plain.json")])
    out = _run_sharded("test_esac", [*argv, "--sharded", "--devices", "2",
                                     "--json", str(d / "sharded.json")])
    assert "sharded routed (3/3 experts/frame)" in out
    plain = json.loads((d / "plain.json").read_text())
    sharded = json.loads((d / "sharded.json").read_text())
    for k in ("frames", "median_rot_deg", "median_trans_cm", "pct_5cm5deg",
              "expert_accuracy_pct", "gating_top1_pct", "evaluated_recall_pct",
              "hypotheses_total"):
        assert sharded[k] == plain[k], k
    for k in ("expert", "rot_err_deg", "trans_err_cm", "winner_score"):
        assert sharded["per_frame"][k] == plain["per_frame"][k], k
    assert sharded["sharded"] is True and sharded["devices"] == 2
    assert sharded["experts_total"] == 3 and sharded["median_hyploop_ms_per_frame"] is None


def test_sharded_flag_rules(stages, monkeypatch, capsys):
    """The JAX scripts' p.error rules, and the port's own: on the card
    --devices N needs N cards (NCCL, no quiet switch)."""
    d, ckpts = stages
    base = [*SCENES, "--cpu", "--size", "test", "--frames", "4", *ckpts]
    cases = [
        (train_esac, ["--capacity", "2"], "only apply with --sharded"),
        (train_esac, ["--sharded", "--capacity", "-1"], "--capacity must be >= 0"),
        (train_esac, ["--sharded", "--estimator", "sampled"], "dense estimator"),
        (train_esac, ["--sharded", "--alpha-start", "0.1"], "--alpha-start with --sharded"),
        (test_esac, ["--sharded", "--topk", "1"], "mutually exclusive"),
    ]
    for module, extra, msg in cases:
        with pytest.raises(SystemExit) as e:
            module.main([*base, *extra])
        assert e.value.code == 2 and msg in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for module in (train_esac, test_esac):
        with pytest.raises(SystemExit):
            module.main([a for a in base if a != "--cpu"] + ["--sharded", "--devices", "2"])
        assert "NCCL needs one card per rank and this host has 1" in capsys.readouterr().err


def test_test_esac_under_a_launcher_environment(stages, monkeypatch, tmp_path):
    """Under torchrun's environment (here a world of one) the script joins
    the launcher's group instead of spawning, and reports the dense
    evaluation."""
    from esac_tpu_torch.parallel.multihost import free_port

    d, ckpts = stages
    argv = [*SCENES, "--cpu", "--size", "test", "--frames", "4", "--hypotheses", "16",
            "--limit", "2", "--eval-batch", "4", *ckpts]
    _run(test_esac, [*argv, "--json", str(tmp_path / "plain.json")])
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    out = _run(test_esac, [*argv, "--sharded", "--json", str(tmp_path / "sharded.json")])
    assert "sharded routed (3/3 experts/frame)" in out
    plain = json.loads((tmp_path / "plain.json").read_text())
    sharded = json.loads((tmp_path / "sharded.json").read_text())
    assert sharded["per_frame"]["expert"] == plain["per_frame"]["expert"]
    assert sharded["per_frame"]["rot_err_deg"] == plain["per_frame"]["rot_err_deg"]
    assert sharded["devices"] == 1


def test_sharded_resume_needs_the_original_rank_count(stages, trained, capsys):
    """The padded expert stack is in the train state: a state saved by 2
    ranks (3 experts padded to 4) cannot resume on 1 rank (no pad)."""
    d, ckpts = stages
    with pytest.raises(SystemExit) as e:
        train_esac.main([*SCENES, *COMMON, "--iterations", "3", "--hypotheses", "16",
                         *ckpts, "--sharded", "--resume", "--output", str(d / "sharded")])
    assert e.value.code == 2
    assert "resumed expert stack is 4 wide" in capsys.readouterr().err
