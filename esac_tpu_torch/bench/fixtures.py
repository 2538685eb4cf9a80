"""What several bench modes build alike: the tiny registry scenes they serve
(checkpoints written from the port's own seeded init), the request frames
they send, the quantiles they report and the lock-witness block the drills
record.  Random inputs come from numpy and torch generators seeded here, so
every run serves the same data on any device."""

from __future__ import annotations

import contextlib
import pathlib
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from esac_tpu_torch.bench.scaffold import ROOT
from esac_tpu_torch.lint.lockgraph import LOCK_GRAPH_NAME, load_graph
from esac_tpu_torch.registry.manifest import SceneEntry, ScenePreset
from esac_tpu_torch.registry.serving import (
    compute_entry_checksums,
    init_scene_params,
    save_scene_params,
)
from esac_tpu_torch.utils.profiling import wait_for

# Request seeds and image streams (the JAX bench's fold_in(key(7), i) and
# fold_in(key(42), i)).
REQUEST_SEED = 7_000_000
IMAGE_SEED = 42


def fence(dev: torch.device) -> None:
    """Wait for the card (the JAX bench's ``block_until_ready``)."""
    wait_for(dev)


@contextlib.contextmanager
def scratch_dir(prefix: str):
    """A temporary directory for a mode's checkpoints, removed after."""
    root = pathlib.Path(tempfile.mkdtemp(prefix=prefix))
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tiny_preset(hw: int, num_experts: int) -> ScenePreset:
    """The drills' toy scene: they measure queueing, faults and scheduling,
    not CNN throughput (``bench.py``'s ``stem_channels=(2, 4, 8)``)."""
    return ScenePreset(height=hw, width=hw, num_experts=num_experts,
                       stem_channels=(2, 4, 8), head_channels=8, head_depth=1,
                       gating_channels=(4,), compute_dtype="float32", gated=True)


def write_scene(root: pathlib.Path, name: str, preset: ScenePreset, cfg, seed: int,
                version: int = 1, dirname: str | None = None, center_step: float = 0.1,
                center_offset: float = 0.0, nan: bool = False,
                checksums: bool = False) -> SceneEntry:
    """A random-init scene (the port's init under ``seed``) written as
    registry checkpoints under ``root/dirname``: expert m's center at
    (m * center_step + center_offset) + (0, 0, 2 m), f = 40, c at the image
    center; ``nan`` poisons every expert weight (structurally valid,
    checksum-consistent); ``checksums`` records content checksums."""
    M, H, W = preset.num_experts, preset.height, preset.width
    params = init_scene_params(preset, seed=seed, device="cpu")
    centers = (np.asarray([[0.0, 0.0, 2.0]], np.float32)
               + np.arange(M, dtype=np.float32)[:, None] * center_step + center_offset)
    params["centers"] = torch.as_tensor(centers)
    params["f"] = torch.tensor(40.0)
    params["c"] = torch.tensor([W / 2.0, H / 2.0])
    if nan:
        with torch.no_grad():
            for p in params["expert"].parameters():
                p.fill_(float("nan"))
    d = root / (dirname or name)
    save_scene_params(params, preset, d / "expert", d / "gating")
    entry = SceneEntry(scene_id=name, version=version, expert_ckpt=str(d / "expert"),
                       gating_ckpt=str(d / "gating"), preset=preset, ransac=cfg)
    return compute_entry_checksums(entry) if checksums else entry


def image(i: int, hw: int) -> np.ndarray:
    """Uniform [0, 1) image number ``i``, (hw, hw, 3) float32."""
    return np.random.default_rng([IMAGE_SEED, i]).random((hw, hw, 3), dtype=np.float32)


def image_frame(i: int, hw: int) -> dict:
    """Image request ``i``: its own seed and image."""
    return {"seed": np.int64(REQUEST_SEED + i), "image": image(i, hw)}


def med(xs):
    return sorted(xs)[len(xs) // 2]


def pct(xs, q):
    xs = sorted(xs)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def join_threads_started_since(before: set, timeout_s: float = 30.0) -> None:
    """Wait, bounded, for the threads a drill started: a dispatch it wedged
    and abandoned runs on once released, and must not still be inside a
    torch call when the caller moves on or the process exits."""
    deadline = time.monotonic() + timeout_s
    for t in threading.enumerate():
        if t not in before and t is not threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))


def accounting_exact(totals: dict) -> bool:
    """Every request in exactly one outcome class: served + shed + expired +
    degraded + failed + pending == offered (a dispatcher's ``slo_totals``,
    a router's ``fleet_totals``, a retrieval front's ``stats``)."""
    return (sum(totals[o] for o in ("served", "shed", "expired", "degraded", "failed"))
            + totals["pending"] == totals["offered"])


def lock_witness_block(witness) -> tuple[dict, dict]:
    """The drills' ``lock_witness`` block: the observed edges held to the
    committed lock graph; also returns the witness snapshot."""
    committed = load_graph(ROOT / LOCK_GRAPH_NAME)
    snap = witness.snapshot()
    violations = witness.violations(committed) if committed is not None else None
    return {
        "edges_observed": snap["edges"],
        "committed_graph_present": committed is not None,
        "violations": violations,
        "observed_subgraph_of_committed": (violations == [] if violations is not None
                                           else None),
    }, snap
