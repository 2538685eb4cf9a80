"""Scene health: typed load/serve faults + the circuit-breaker policy (a copy
of ``esac_tpu/registry/health.py``, with the probe reduced on the card).

- **Typed registry faults.**  :class:`SceneLoadError` (a checkpoint read
  kept failing past the loader's capped retry/backoff) and
  :class:`ChecksumMismatchError` (the loaded content does not hash to the
  manifest's recorded checksum -- corrupt or swapped weights) subclass
  BOTH :class:`~esac_tpu_torch.registry.manifest.ManifestError` and
  :class:`~esac_tpu_torch.serve.slo.ServeError` (so a dispatch failing on
  them fans out as one typed serving outcome).
  :class:`SceneUnhealthyError` is the breaker's shed: the resolved
  (scene, version) is known-bad and has no rollback target.  All three
  are **non-retryable**: the loader already retried transients
  internally, so the dispatcher skips its retry loop for them.

- **:class:`HealthPolicy`**: the frozen host-side knob set for the
  per-(scene, version) breaker and canary promotion.  Like
  :class:`~esac_tpu_torch.serve.slo.SLOPolicy` it does NOT ride
  ``RansacConfig``.

- **The health sample**: per-frame finiteness of the dispatch winner
  (rvec/tvec/inlier_frac).  NaN weights or a poisoned checkpoint surface
  as non-finite winners.  :func:`finite_frames` launches the per-frame
  reduction where the leaves live (on the card: no synchronization) when
  the dispatch is enqueued; :func:`count_unhealthy` reads that small
  result one dispatch later, when it is long materialized.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from esac_tpu_torch.registry.manifest import ManifestError
from esac_tpu_torch.serve.slo import ServeError


class SceneLoadError(ManifestError, ServeError):
    """A scene checkpoint failed to load after the capped retry/backoff
    (persistent IO fault) — or failed in a way retrying cannot fix
    (unparsable sidecar).  Non-retryable at the dispatch layer: the
    loader already retried the transient window."""

    retryable = False
    wire_name = "scene_load"


class ChecksumMismatchError(SceneLoadError):
    """The loaded checkpoint content does not hash to the manifest
    entry's recorded checksum: corrupt at rest, corrupted in the read
    path, or pointing at the wrong weights.  Serving it would be
    silently-garbage poses; failing typed is the contract."""

    retryable = False
    wire_name = "checksum_mismatch"


class SceneUnhealthyError(ServeError):
    """The breaker for the resolved (scene, version) is OPEN and no
    last-known-good version exists to roll back to; the scene is shed
    typed until an operator ``release_scene``s it (mirroring
    ``release_lane``)."""

    retryable = False
    wire_name = "scene_unhealthy"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Host-side knobs of the scene health breaker + canary promotion.

    The breaker scores each dispatch's winner per (scene, version): a
    frame whose rvec/tvec/inlier_frac is non-finite is *bad* (NaN
    weights, irrecoverably degenerate geometry — the finite-garbage+
    penalty convention means a healthy pipeline never emits non-finite
    winners).  When the recent window holds >= ``min_samples`` frames
    and the bad fraction reaches ``trip_bad_frac``, the breaker trips:
    the version stops serving, and — when the manifest holds a previous
    version and ``auto_rollback`` — the scene auto-rolls back to it
    (pointer swap only: same preset, same bucket functions, no new batch
    signature).  Without a rollback target the scene sheds typed
    (:class:`SceneUnhealthyError`) until ``release_scene``.
    """

    # Per-(scene, version) ring: health is judged over the last `window`
    # DISPATCH samples (each carrying its frame count).
    window: int = 64
    # Minimum frames in the window before the breaker may trip — one
    # unlucky frame must not shed a scene.
    min_samples: int = 8
    # Bad-frame fraction (over the window) that trips the breaker.
    trip_bad_frac: float = 0.5
    # Tripping the ACTIVE version rolls the scene back to the manifest's
    # previous version when one exists (else the scene sheds typed).
    auto_rollback: bool = True
    # Evict a tripped version's device weights (frees HBM for the fleet;
    # the rolled-back-to version's tree is typically still cached).
    evict_on_trip: bool = True
    # Canary promotion: frames the canary must serve before the
    # health comparison against the incumbent can finalize it.
    canary_min_samples: int = 16
    # Finalize iff canary_bad_frac <= incumbent_bad_frac + this slack;
    # otherwise the canary auto-rolls back (the incumbent never left the
    # active pointer, so "rollback" is dropping the canary route).
    canary_bad_slack: float = 0.0
    # Ring bound on the health-event log (trips, rollbacks, canary
    # decisions) — observability, host-memory-flat like dispatcher stats.
    events_window: int = 1000

    def __post_init__(self):
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if not 0.0 < self.trip_bad_frac <= 1.0:
            raise ValueError(
                f"trip_bad_frac {self.trip_bad_frac} outside (0, 1]"
            )
        if self.canary_min_samples < 1 or self.events_window < 1:
            raise ValueError(
                "canary_min_samples and events_window must be >= 1"
            )
        if self.canary_bad_slack < 0.0:
            raise ValueError(f"canary_bad_slack {self.canary_bad_slack} < 0")


def finite_frames(leaves: dict[str, Any]):
    """Per-frame "every leaf finite" of one dispatch's winner leaves (each
    with a leading frame axis): a (B,) bool tensor computed where the
    tensors live -- on the card an asynchronous reduction that adds no
    synchronization -- or a numpy array for numpy leaves; None for no
    leaves.  Padding lanes ride along and cannot dilute the signal:
    ``pad_batch`` repeats the last real frame (seed included), so a
    padding lane's vote mirrors that frame's, and the faults this breaker
    targets (NaN / poisoned WEIGHTS) corrupt every lane of a dispatch
    alike."""
    ok = None
    with torch.inference_mode():
        for v in leaves.values():
            if isinstance(v, torch.Tensor):
                f = torch.isfinite(v).reshape(v.shape[0], -1).all(1)
            else:
                a = np.asarray(v)
                f = np.isfinite(a).reshape(a.shape[0], -1).all(axis=1)
            ok = f if ok is None else ok & f
    return ok


def count_unhealthy(ok) -> tuple[int, int]:
    """(bad, total) frame counts from :func:`finite_frames`' result -- the
    deferred read (one small copy from the card)."""
    if ok is None:
        return 0, 0
    ok = ok.cpu().numpy() if isinstance(ok, torch.Tensor) else np.asarray(ok)
    return int((~ok).sum()), int(ok.size)


def unhealthy_frames(leaves: dict[str, Any]) -> tuple[int, int]:
    """(bad, total) frame counts of one dispatch's winner leaves; a frame
    is bad when ANY leaf holds a non-finite value for it."""
    return count_unhealthy(finite_frames(leaves))
