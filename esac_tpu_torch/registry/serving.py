"""Scene serving (the port of ``esac_tpu/registry/serving.py``): the bucket
functions, the registry checkpoint loader and :class:`SceneRegistry`.

``make_scene_bucket_fn(preset, cfg)`` returns ``fn(params, batch)``: every
expert CNN over the batch plus its scene center, the gating CNN (or zero
logits for ungated presets), then frames-major multi-expert RANSAC
(``esac_infer_frames``).  Per-scene quantities -- weights, centers, focal,
principal point -- ride ``params``, so one bucket function serves every
scene of a preset.

``params`` is the dict :func:`init_scene_params` builds: ``expert`` (an
``nn.ModuleList`` of M ``ExpertNet``), ``gating`` (``GatingNet`` or None),
``centers`` (M, 3), ``f`` (), ``c`` (2,), all on the serving device;
``models.convert.load_scene`` fills it from the JAX package's
``load_scene_params`` tree.  ``batch`` holds ``image`` (B, H, W, 3), a
per-frame ``seed`` (B,) in place of the JAX package's PRNG keys, and
optionally ``idx`` (B, M, n_hyps, 4) injected correspondence sets; a
session lane's batch adds ``prior_rvec`` / ``prior_tvec`` (B, P, 3) and
``prior_valid`` (B, P), and is served through the prior-slot entries
(``esac_infer_frames_prior``, ``esac_infer_routed_frames_prior``).

``make_routed_scene_bucket_fn(preset, cfg, k)`` serves gating first: the
gating CNN, each frame's top-k experts, then each expert's CNN over ONE
fixed block of ``routed_serve_capacity(cfg, k, M)`` frames that selected
it (``parallel.esac_sharded.route_frames_to_experts``), and the routed
hypothesis loop with the budget reallocated over the k experts.  The
block width is one constant per (cfg, k), so a frame's expert CNNs run at
the same width in every frame bucket.  At k = M it runs the dense CNN
schedule and equals ``make_scene_bucket_fn`` bit for bit.

Both bucket functions record the batch signatures they run
(``fn._cache_size()``, ``serve.batching.count_signatures``): PyTorch
compiles nothing per shape, so where the JAX package counts compiled
programs the port counts signatures -- one per frame bucket (and per
prior-slot batch shape), shared by every scene of a (preset, cfg).

The registry checkpoint (``load_scene_params`` / :func:`save_scene_params`)
has the JAX package's layout, in torch files (``utils/checkpoint``): an
expert checkpoint holding all M experts' state dicts stacked on a leading
M axis, with a ``config.json`` of ``stem_channels``, ``head_channels``,
``head_depth``, ``scene_centers`` (M, 3), ``f`` and ``c``; a gating
checkpoint (gated presets) with ``num_experts``.  The loader returns that
tree on the host; :func:`stage_scene_params` builds the scene's modules on
the ``meta`` device and assigns the tensors copied to the serving device
(no random init), which is what :class:`SceneRegistry`'s weight cache
holds.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.data.synthetic import CAMERA_F, output_pixel_grid
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.ransac.config import RansacConfig
from esac_tpu_torch.parallel.esac_sharded import route_frames_to_experts
from esac_tpu_torch.ransac.esac import (
    esac_infer_frames,
    esac_infer_frames_prior,
    esac_infer_routed_frames,
    esac_infer_routed_frames_prior,
    routed_serve_capacity,
    select_topk_experts,
)
from esac_tpu_torch.ransac.kernel import as_f32, frame_generators
from esac_tpu_torch.obs import MetricsRegistry
from esac_tpu_torch.obs.trace import active_traces
from esac_tpu_torch.registry.cache import DeviceWeightCache
from esac_tpu_torch.registry.health import (
    ChecksumMismatchError,
    HealthPolicy,
    SceneLoadError,
    SceneUnhealthyError,
    count_unhealthy,
    finite_frames,
)
from esac_tpu_torch.registry.manifest import (
    ManifestError,
    SceneEntry,
    SceneManifest,
    ScenePreset,
    params_checksum,
)
from esac_tpu_torch.serve.batching import MIN_LANES, count_signatures
from esac_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from esac_tpu_torch.utils.precision import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_scene_params(preset: ScenePreset, seed: int = 0, device=None) -> dict:
    """A scene with the port's own random initialization from ``seed``
    (PyTorch's default layer init under a forked, seeded RNG; the global
    RNG is left as it was), zero centers and the default camera scaled to
    the preset's width.  Modules are in eval mode on ``device``."""
    dev = resolve_device(device)
    dtype = _DTYPES[preset.compute_dtype]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        experts = nn.ModuleList(
            ExpertNet(stem_channels=preset.stem_channels,
                      head_channels=preset.head_channels,
                      head_depth=preset.head_depth, compute_dtype=dtype)
            for _ in range(preset.num_experts)
        )
        gating = GatingNet(preset.num_experts, preset.gating_channels,
                           compute_dtype=dtype) if preset.gated else None
    return {
        "expert": experts.to(dev).eval(),
        "gating": None if gating is None else gating.to(dev).eval(),
        "centers": torch.zeros((preset.num_experts, 3), device=dev),
        "f": torch.tensor(CAMERA_F * preset.width / 640.0, device=dev),
        "c": torch.tensor([preset.width / 2.0, preset.height / 2.0], device=dev),
    }


def scene_forward(params: dict, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert CNN over ``imgs`` (B, H, W, 3) plus its scene center,
    and the gating CNN (zero logits for an ungated preset).  Returns coords
    (B, M, n_cells, 3) and logits (B, M); differentiable where the modules
    are (the training step runs it under autograd)."""
    B, M = imgs.shape[0], len(params["expert"])
    coords = torch.stack([net(imgs) for net in params["expert"]], dim=1)
    coords = coords.reshape(B, M, -1, 3) + params["centers"][None, :, None, :]
    if params["gating"] is None:
        return coords, torch.zeros((B, M), device=imgs.device)
    return coords, params["gating"](imgs)


def make_scene_bucket_fn(preset: ScenePreset, cfg: RansacConfig, device=None):
    """The full pipeline for a (preset, cfg) bucket: ``fn(params, batch)``
    -> per-frame result dict (see the module docstring).  Runs under
    ``torch.inference_mode``; every tensor stays on ``device``."""
    dev = resolve_device(device)
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device=dev)

    def run(params: dict, batch: dict) -> dict:
        with torch.inference_mode():
            imgs = as_f32(batch["image"], dev)
            B = imgs.shape[0]
            coords, logits = scene_forward(params, imgs)
            args = (frame_generators(batch["seed"], dev), logits, coords, pixels,
                    params["f"].expand(B), params["c"])
            if "prior_rvec" in batch:
                return esac_infer_frames_prior(*args, *_priors(batch), cfg,
                                               idx=batch.get("idx"), device=dev)
            return esac_infer_frames(*args, cfg, idx=batch.get("idx"), device=dev)

    return count_signatures(run)


def _priors(batch: dict) -> tuple:
    return batch["prior_rvec"], batch["prior_tvec"], batch["prior_valid"]


def make_routed_scene_bucket_fn(preset: ScenePreset, cfg: RansacConfig, k: int,
                                device=None):
    """Gating-first routed serving for a (preset, cfg, k) bucket (the
    module docstring): ``fn(params, batch)`` -> per-frame result dict, with
    'experts_evaluated' (B, k) (sentinel M where capacity dropped the
    pair).  Raises ``ManifestError`` for k outside 1..M, or k < M on an
    ungated preset (every frame would ride one arbitrary subset)."""
    M = preset.num_experts
    if not 1 <= k <= M:
        raise ManifestError(f"routed top-k {k} outside 1..{M}")
    if k < M and not preset.gated:
        raise ManifestError("routed serving with k < num_experts needs a gated preset: "
                            "without a gating net every frame would ride the same "
                            "arbitrary expert subset")
    cap = routed_serve_capacity(cfg, k, M)
    dev = resolve_device(device)
    pixels = output_pixel_grid(preset.height, preset.width, preset.stride, device=dev)

    def run(params: dict, batch: dict) -> dict:
        with torch.inference_mode():
            imgs = as_f32(batch["image"], dev)
            B = imgs.shape[0]
            if k == M:  # identity routing: the dense CNN schedule
                coords, logits = scene_forward(params, imgs)
                selected = torch.arange(M, device=dev).expand(B, M)
                kept = torch.ones((B, M), dtype=torch.bool, device=dev)
            else:
                logits = params["gating"](imgs)
                selected = select_topk_experts(logits, k)
                kept, pos, slot_frame, _ = route_frames_to_experts(selected, M, cap)
                # One forward per expert over its fixed block of cap frames;
                # dropped pairs gather a clamped (wrong) row: finite garbage
                # that the hypothesis loop scores -inf.
                blocks = torch.stack([net(imgs[slot_frame[m]])
                                      for m, net in enumerate(params["expert"])])
                blocks = blocks.reshape(M, cap, -1, 3) + params["centers"][:, None, None, :]
                coords = blocks[selected, pos.clamp(max=cap - 1)]
            args = (frame_generators(batch["seed"], dev), logits, coords, selected, kept,
                    pixels, params["f"].expand(B), params["c"])
            if "prior_rvec" in batch:
                return esac_infer_routed_frames_prior(*args, *_priors(batch), cfg,
                                                      idx=batch.get("idx"), device=dev)
            return esac_infer_routed_frames(*args, cfg, idx=batch.get("idx"), device=dev)

    return count_signatures(run)


# ---------------------------------------------------------------- loading

# Capped retry/backoff for transient checkpoint-read faults (OSError: a
# flaky network filesystem, a mid-rotation file, an interrupted read): two
# retries with a ~50 ms base absorb single-blip faults.  Each retry sleeps
# uniform(base, 3 * previous sleep), capped -- "decorrelated jitter", so
# replicas faulting on one store do not retry in lockstep.
LOAD_RETRIES = 2
LOAD_BACKOFF_S = 0.05
LOAD_BACKOFF_CAP_S = 1.0
_BACKOFF_RNG = random.Random()


def _read_with_retry(path, what, read_checkpoint, retries, backoff_s, rng=None):
    """``load_checkpoint`` with capped, decorrelated-jitter retry backoff
    on transient IO faults.  OSError is the transient class (retried);
    anything else -- an unparsable sidecar, a truncated torch file -- is
    deterministic and wraps immediately into a typed, non-retryable
    SceneLoadError.  ``rng`` overrides the jitter source."""
    read = read_checkpoint if read_checkpoint is not None else load_checkpoint
    uniform = (rng if rng is not None else _BACKOFF_RNG).uniform
    attempt = 0
    sleep_s = backoff_s
    while True:
        try:
            return read(path)
        except OSError as e:
            attempt += 1
            if attempt > retries:
                raise SceneLoadError(
                    f"{what}: checkpoint {path!r} failed to load after "
                    f"{attempt} attempts (last: {e!r})"
                ) from e
            sleep_s = min(LOAD_BACKOFF_CAP_S,
                          uniform(backoff_s, max(backoff_s, 3.0 * sleep_s)))
            time.sleep(sleep_s)
        except (SceneLoadError, ManifestError):
            raise
        except Exception as e:  # noqa: BLE001 -- typed boundary
            raise SceneLoadError(
                f"{what}: checkpoint {path!r} is unreadable (not transient: {e!r})"
            ) from e


def _verify_checksum(entry, role, params, config):
    """Compare loaded content against the manifest's recorded checksum for
    ``role`` (no-op when the entry carries none)."""
    want = entry.checksum_map.get(role)
    if want is None:
        return
    got = params_checksum(params, config)
    if got != want:
        raise ChecksumMismatchError(
            f"{entry.scene_id} v{entry.version}: {role} checkpoint content "
            f"hash {got[:12]}… != manifest {want[:12]}… — corrupt or "
            "swapped weights; refusing to serve them"
        )


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def load_scene_params(
    entry: SceneEntry,
    *,
    retries: int = LOAD_RETRIES,
    backoff_s: float = LOAD_BACKOFF_S,
    read_checkpoint=None,
    rng=None,
) -> dict:
    """Default weight-cache loader: the registry checkpoints -> one host tree.

    Reads the expert (and, for gated presets, gating) checkpoints through
    ``utils/checkpoint.load_checkpoint`` (host tensors) and validates the
    config sidecar against the manifest preset, so a manifest that points a
    preset at weights of another architecture fails at LOAD time with a
    precise error.  Transient IO faults are retried with capped backoff and
    surface as a typed ``SceneLoadError`` only once exhausted; when the
    entry carries content ``checksums``, the loaded tree + config must hash
    back to them or the load fails with a typed ``ChecksumMismatchError``.
    ``read_checkpoint`` overrides the reader (the FaultInjector hook).

    The tree: ``expert`` (the M experts' state dicts stacked on a leading
    axis), ``gating`` (gated presets only), ``centers`` (M, 3), ``c`` (2,),
    ``f`` () -- float32 tensors on the CPU.
    """
    p = entry.preset
    what = f"{entry.scene_id} v{entry.version}"
    params_e, cfg_e = _read_with_retry(entry.expert_ckpt, what, read_checkpoint,
                                       retries, backoff_s, rng)
    _verify_checksum(entry, "expert", params_e, cfg_e)
    for field in ("stem_channels", "head_channels", "head_depth"):
        want = getattr(p, field)
        got = cfg_e.get(field)
        got = tuple(got) if isinstance(got, list) else got
        if got != want:
            raise ManifestError(f"{what}: expert checkpoint {field}={got!r} but the "
                                f"manifest preset says {want!r}")
    for field in ("scene_centers", "f", "c"):
        if field not in cfg_e:
            raise ManifestError(f"{what}: expert checkpoint config lacks {field!r} "
                                "(not a registry-servable checkpoint)")
    centers = torch.as_tensor(np.asarray(cfg_e["scene_centers"], np.float32))
    if tuple(centers.shape) != (p.num_experts, 3):
        raise ManifestError(f"{what}: scene_centers shape {tuple(centers.shape)} != "
                            f"({p.num_experts}, 3)")
    leaves = list(_tensor_leaves(params_e))
    if leaves and leaves[0].shape[0] != p.num_experts:
        raise ManifestError(
            f"{what}: expert params leading axis {leaves[0].shape[0]} != preset "
            f"num_experts {p.num_experts} (experts must be stacked)")
    tree = {
        "expert": params_e,
        "centers": centers,
        "c": torch.as_tensor(np.asarray(cfg_e["c"], np.float32).reshape(2)),
        "f": torch.tensor(float(cfg_e["f"]), dtype=torch.float32),
    }
    if p.gated:
        params_g, cfg_g = _read_with_retry(entry.gating_ckpt, what, read_checkpoint,
                                           retries, backoff_s, rng)
        _verify_checksum(entry, "gating", params_g, cfg_g)
        if int(cfg_g.get("num_experts", -1)) != p.num_experts:
            raise ManifestError(f"{what}: gating checkpoint num_experts="
                                f"{cfg_g.get('num_experts')!r} != preset {p.num_experts}")
        tree["gating"] = params_g
    return tree


def compute_entry_checksums(entry: SceneEntry, read_checkpoint=None) -> SceneEntry:
    """Author-side helper: load the entry's checkpoints once and return the
    entry with content ``checksums`` recorded, so every later load verifies
    against the content that was actually reviewed."""
    read = read_checkpoint if read_checkpoint is not None else load_checkpoint
    sums = [("expert", params_checksum(*read(entry.expert_ckpt)))]
    if entry.gating_ckpt is not None:
        sums.append(("gating", params_checksum(*read(entry.gating_ckpt))))
    return dataclasses.replace(entry, checksums=tuple(sums))


def save_scene_params(params: dict, preset: ScenePreset, expert_path,
                      gating_path=None) -> None:
    """Write a scene (an :func:`init_scene_params`-shaped dict) as registry
    checkpoints: the experts' state dicts stacked on a leading M axis with
    the preset's widths, ``scene_centers``, ``f`` and ``c`` beside them;
    the gating net's state dict with ``num_experts`` (gated presets)."""
    states = [net.state_dict() for net in params["expert"]]
    save_checkpoint(expert_path, {k: torch.stack([s[k] for s in states]) for k in states[0]}, {
        "stem_channels": list(preset.stem_channels),
        "head_channels": preset.head_channels,
        "head_depth": preset.head_depth,
        "scene_centers": params["centers"].tolist(),
        "f": float(params["f"]),
        "c": params["c"].tolist(),
    })
    if preset.gated:
        save_checkpoint(gating_path, params["gating"].state_dict(),
                        {"num_experts": preset.num_experts})


def stage_scene_params(host: dict, preset: ScenePreset, device=None) -> dict:
    """A :func:`load_scene_params` tree as the param dict the bucket
    functions take, on ``device``: the modules are built on the ``meta``
    device (no random init, no allocation) and take the host tensors, copied
    to ``device`` once per leaf, by ``load_state_dict(..., assign=True)``.
    Modules are in eval mode."""
    dev = resolve_device(device)
    dtype = _DTYPES[preset.compute_dtype]
    with torch.device("meta"):
        experts = nn.ModuleList(
            ExpertNet(stem_channels=preset.stem_channels, head_channels=preset.head_channels,
                      head_depth=preset.head_depth, compute_dtype=dtype)
            for _ in range(preset.num_experts))
        gating = GatingNet(preset.num_experts, preset.gating_channels,
                           compute_dtype=dtype) if preset.gated else None
    stacked = {k: v.to(dev) for k, v in host["expert"].items()}
    for m, net in enumerate(experts):
        net.load_state_dict({k: v[m] for k, v in stacked.items()}, assign=True)
    if gating is not None:
        gating.load_state_dict({k: v.to(dev) for k, v in host["gating"].items()},
                               assign=True)
    return {
        "expert": experts.eval(),
        "gating": None if gating is None else gating.eval(),
        "centers": host["centers"].to(dev),
        "f": host["f"].to(dev),
        "c": host["c"].to(dev),
    }


# ---------------------------------------------------------------- registry


class SceneRegistry:
    """Manifest + device weight cache + per-bucket bucket functions.

    The serving facade: ``infer_fn()`` yields the scene-aware callable the
    :class:`~esac_tpu_torch.serve.dispatcher.MicroBatchDispatcher` drives
    (``fn(batch, scene)``), resolving the scene's ACTIVE manifest entry and
    cached device weights **per dispatch** -- which is exactly what gives
    promote/rollback their drain semantics: a dispatch in flight keeps the
    entry and params it resolved; the next dispatch sees the new pointer.
    Everything runs on ``device`` (``None`` = the card; raises without one
    unless the caller passes ``device="cpu"``).

    Scene health: with a
    :class:`~esac_tpu_torch.registry.health.HealthPolicy` (the default),
    every dispatch's winner is scored into a per-(scene, version) circuit
    breaker -- the per-frame finiteness reduction is launched with the
    dispatch and read one dispatch DEFERRED, so the probe never stalls
    in-flight compute.  A version whose recent window goes bad (non-finite
    poses: NaN weights, a poisoned checkpoint) trips: the scene
    **auto-rolls back** to the manifest's previous version when one exists
    (a pointer swap -- same preset, same bucket functions, results
    bit-identical to loading that version directly) or sheds typed
    (:class:`~esac_tpu_torch.registry.health.SceneUnhealthyError`) until an
    operator :meth:`release_scene`\\ s it.  :meth:`promote` with
    ``canary=`` routes a bounded fraction of the scene's traffic to the new
    version, compares its health against the incumbent and auto-finalizes
    or auto-rolls back -- the active pointer never moves until the canary
    earns it.  All health state lives under one instance lock;
    pointer/cache actions derived from a trip are executed OUTSIDE it
    (single-shot, guarded by the tripped set), so the lock order
    health -> manifest has no health -> cache edge, and nothing blocks
    under these locks (loads ride the cache's per-key futures; probe reads
    are deferred off-lock in ``_drain_probes``).
    """

    def __init__(
        self,
        manifest: SceneManifest,
        budget_bytes: int | None = None,
        loader=load_scene_params,
        device=None,
        health: HealthPolicy | None = HealthPolicy(),
        clock=time.perf_counter,
        obs: MetricsRegistry | None = None,
    ):
        self.manifest = manifest
        self.device = resolve_device(device)
        self.cache = DeviceWeightCache(
            loader, budget_bytes, self.device,
            stage=lambda entry, host: stage_scene_params(host, entry.preset, self.device))
        self._fns: dict = {}
        self._fns_lock = threading.Lock()
        self._health_policy = health
        self._clock = clock
        # Observability: the registry owns its health instruments and a
        # home obs registry; ``bind_obs`` adopts the SAME instrument and
        # collector objects into a dispatcher's registry so one snapshot
        # covers serve + registry + cache (see :meth:`dispatcher`).
        self.obs = obs if obs is not None else MetricsRegistry()
        self._m_probe_frames = self.obs.counter(
            "registry_probe_frames_total",
            "health-probe frames folded per (scene, version)",
        )
        self._m_bad_frames = self.obs.counter(
            "registry_unhealthy_frames_total",
            "non-finite-winner frames per (scene, version)",
        )
        self._m_health_events = self.obs.counter(
            "registry_health_events_total",
            "breaker/canary events by kind (trips, rollbacks, promotes)",
        )
        self.obs.register_collector("scene_health",
                                    self._health_collector)
        self.cache.bind_obs(self.obs)
        self._health_lock = threading.Lock()
        # Deferred probes: (key, per-frame finiteness on the device).
        self._probes: collections.deque = collections.deque()
        # key -> deque[(bad, total)] over the last `window` dispatches.
        self._samples: dict = {}
        self._tripped: dict = {}           # key -> reason
        self._canaries: dict = {}          # scene -> canary state dict
        self.health_events: collections.deque = collections.deque(
            maxlen=(health.events_window if health else 1)
        )

    def _fn_for(self, entry: SceneEntry, route_k: int | None = None):
        """The bucket function serving ``entry``: dense when ``route_k``
        is None (and the scene's cfg sets no ``serve_topk``), else the
        gating-first routed function for top-``route_k`` experts.
        Functions are cached per (bucket key, K) -- scenes sharing
        preset+cfg share every function, so a hot swap adds no batch
        signature at any K."""
        if route_k is None and entry.ransac.serve_topk > 0:
            route_k = entry.ransac.serve_topk
        # NOTE: every distinct route_k is a PERMANENT cached function --
        # callers own the cardinality.
        key = (entry.bucket_key(), route_k)
        with self._fns_lock:
            fn = self._fns.get(key)
            if fn is None:
                fn = (
                    make_scene_bucket_fn(entry.preset, entry.ransac, self.device)
                    if route_k is None
                    else make_routed_scene_bucket_fn(
                        entry.preset, entry.ransac, route_k, self.device
                    )
                )
                self._fns[key] = fn
            return fn

    @staticmethod
    def _batch_frames(batch) -> int:
        """Leading-axis frame count of a dispatch batch tree — the
        weight of its health sample.  Frames-major contract: every
        shaped leaf shares the frame axis; the named leaves are
        preferred.  1 when nothing is
        shaped (a failure sample must never weigh 0)."""
        leaves = [batch]
        if isinstance(batch, dict):
            named = [batch[k] for k in ("image", "coords_all", "pixels")
                     if k in batch]
            leaves = named + list(batch.values())
        for leaf in leaves:
            shp = getattr(leaf, "shape", None)
            if shp:
                return int(shp[0])
        return 1

    def infer_fn(self):
        """The dispatcher-facing callable: ``fn(batch, scene[, route_k])``
        — ``route_k`` selects the top-K routed function for the dispatch
        (None = the scene's default: dense, or ``cfg.serve_topk``).
        With a health policy, each call
        first settles the previous dispatches' health probes (trips,
        rollbacks and canary decisions land here, BETWEEN dispatches),
        resolves through the breaker/canary, and enqueues this
        dispatch's probe."""

        def serve(batch, scene, route_k=None):
            if self._health_policy is None:
                entry = self.manifest.resolve(scene)
                params = self.cache.get(entry)
                return self._fn_for(entry, route_k)(params, batch)
            self._drain_probes()
            entry = self._resolve_serving(scene)
            # Program resolution FIRST, outside the health-sampled
            # region: an invalid route_k raises here and is the CALLER's
            # fault — sampling it would let one misbehaving client trip a
            # healthy version's breaker.
            fn = self._fn_for(entry, route_k)
            try:
                params = self.cache.get(entry)
                out = fn(params, batch)
            except Exception:
                # A dispatch that fails on the VERSION's own surface —
                # load fault, checksum mismatch, the call itself — IS
                # a health signal: without this, a canary whose
                # checkpoint cannot even load would never accumulate
                # probes and the canary would dangle forever -- and an
                # active version that stops loading
                # could never earn its auto-rollback.  The sample weighs
                # the dispatch's FRAME count so it carries the same unit
                # as a healthy probe (which weighs bucket-size frames).
                self._record_failure_sample(entry.key,
                                            self._batch_frames(batch))
                raise
            self._enqueue_probe(entry.key, out)
            return out

        serve._cache_size = self.compile_cache_size
        return serve

    # ---------------- scene health: breaker + canary ----

    def promote(self, scene_id: str, version: int, canary: float | None = None):
        """Point a scene at ``version``.  ``canary=None`` is the atomic
        manifest promote.  With
        ``canary`` in (0, 1), the ACTIVE pointer does not move: that
        fraction of the scene's subsequent dispatches resolves the new
        version instead, its health is compared against the incumbent
        once ``canary_min_samples`` frames landed, and the canary
        auto-finalizes (manifest promote) or auto-rolls back (the route
        is dropped; the incumbent never left).  ``release_scene`` is the
        operator override.

        Either path refuses a version whose breaker is TRIPPED: moving
        the pointer onto known-bad weights would shed every dispatch
        typed AND quarantine the lane — a routine re-promote after a fix
        must go through ``release_scene`` first, which is where the
        operator asserts the fix actually happened.  (Direct
        ``manifest.promote`` bypasses this guard — it is the raw
        pointer-swap primitive; the registry facade is the one that
        knows about health.)

        A plain promote also refuses while the scene has a canary in
        flight: the canary's eventual finalize is a ``manifest.promote``
        of ITS version, so a pointer moved underneath it would be
        silently reverted when the stale canary wins its health
        comparison — ``release_scene`` cancels the canary first, which
        makes the operator's intent explicit."""
        if canary is None:
            with self._health_lock:
                reason = self._tripped.get((scene_id, version))
                inflight = self._canaries.get(scene_id)
            if inflight is not None:
                raise ManifestError(
                    f"{scene_id!r} has a canary in flight "
                    f"(v{inflight['version']}); release_scene() to cancel "
                    "it before moving the pointer — a stale canary "
                    "finalizing later would silently revert this promote"
                )
            if reason is not None:
                raise ManifestError(
                    f"{scene_id!r} v{version} is breaker-tripped "
                    f"({reason}); release_scene() it before re-promoting"
                )
            return self.manifest.promote(scene_id, version)
        if self._health_policy is None:
            raise ManifestError(
                "canary promotion needs a HealthPolicy (the canary's "
                "verdict IS its health record)"
            )
        if not 0.0 < canary < 1.0:
            raise ManifestError(f"canary fraction {canary} outside (0, 1)")
        entry = self.manifest.entry(scene_id, version)
        incumbent = self.manifest.active_version(scene_id)
        if incumbent == version:
            raise ManifestError(
                f"{scene_id!r} v{version} is already active — nothing to "
                "canary"
            )
        with self._health_lock:
            if scene_id in self._canaries:
                raise ManifestError(
                    f"{scene_id!r} already has a canary in flight "
                    f"(v{self._canaries[scene_id]['version']})"
                )
            if (scene_id, version) in self._tripped:
                raise ManifestError(
                    f"{scene_id!r} v{version} is breaker-tripped; "
                    "release_scene() it before re-promoting"
                )
            self._canaries[scene_id] = {
                "version": version, "incumbent": incumbent,
                "fraction": float(canary), "count": 0,
                "t_start": self._clock(),
            }
            self.health_events.append({
                "t": self._clock(), "event": "canary_start",
                "scene": scene_id, "version": version,
                "incumbent": incumbent, "fraction": float(canary),
            })
        return entry

    def release_scene(self, scene_id: str, version: int | None = None) -> bool:
        """Operator override mirroring ``release_lane``: clear the
        breaker state (and stats) for a scene — one version or all — and
        cancel its in-flight canary, after the underlying fault (fixed
        checkpoint, recovered storage) is resolved.  Idempotent — a
        double release is a no-op, and a release racing a concurrent
        breaker trip is safe: the trip's deferred pointer/evict action
        re-checks the tripped state before executing (see :meth:`_act`),
        so an operator's "the weights are good" assertion is never
        silently undone by a stale trip.  True when any breaker state
        or canary was actually cleared."""
        cleared = False
        with self._health_lock:
            for key in [k for k in self._tripped
                        if k[0] == scene_id
                        and (version is None or k[1] == version)]:
                del self._tripped[key]
                cleared = True
            for key in [k for k in self._samples
                        if k[0] == scene_id
                        and (version is None or k[1] == version)]:
                del self._samples[key]
                cleared = True
            c = self._canaries.get(scene_id)
            if c is not None and (version is None or c["version"] == version):
                del self._canaries[scene_id]
                cleared = True
                self.health_events.append({
                    "t": self._clock(), "event": "canary_cancelled",
                    "scene": scene_id, "version": c["version"],
                    "incumbent": c["incumbent"],
                })
        return cleared

    def health(self, drain: bool = True) -> dict:
        """Locked snapshot of the breaker: per-(scene, version) window
        stats + trip reasons (keyed ``"<scene>@v<version>"`` — the whole
        snapshot is json.dumps-able, the driver/monitor contract), the
        in-flight canaries, and the bounded event log.  ``drain``
        settles pending probes first (the default — a monitor wants the
        truth as of the last completed dispatch)."""
        if drain and self._health_policy is not None:
            self._drain_probes()
        with self._health_lock:
            scenes = {}
            for key, dq in self._samples.items():
                tot = sum(t for _, t in dq)
                bad = sum(b for b, _ in dq)
                scenes[f"{key[0]}@v{key[1]}"] = {
                    "scene": key[0], "version": key[1],
                    "frames": tot, "bad": bad,
                    "bad_frac": (bad / tot) if tot else 0.0,
                    "tripped": self._tripped.get(key),
                }
            for key, reason in self._tripped.items():
                scenes.setdefault(f"{key[0]}@v{key[1]}", {
                    "scene": key[0], "version": key[1],
                    "frames": 0, "bad": 0, "bad_frac": 0.0,
                    "tripped": reason,
                })
            return {
                "scenes": scenes,
                "canaries": {s: dict(c) for s, c in self._canaries.items()},
                "events": [dict(e) for e in self.health_events],
            }

    def _enqueue_probe(self, key, out) -> None:
        """Launch this dispatch's per-frame finiteness reduction over its
        winner leaves (asynchronous on the card: no synchronization) and
        stash the small result for DEFERRED evaluation at the next
        serve/health call, when it is long materialized."""
        leaves = {k: out[k] for k in ("rvec", "tvec", "inlier_frac")
                  if k in out}
        if not leaves:
            return
        ok = finite_frames(leaves)
        with self._health_lock:
            self._probes.append((key, ok))

    def _drain_probes(self) -> None:
        """Settle pending probes: read them (the copies from the card
        OUTSIDE the health lock), fold into the per-key windows, and execute any
        trip/rollback/canary action exactly once."""
        with self._health_lock:
            if not self._probes:
                return
            pending = list(self._probes)
            self._probes.clear()
        evaluated = [
            (key, *count_unhealthy(ok)) for key, ok in pending
        ]
        for key, bad, total in evaluated:
            self._m_probe_frames.inc(total, scene=key[0], version=key[1])
            if bad:
                self._m_bad_frames.inc(bad, scene=key[0], version=key[1])
        actions = []
        with self._health_lock:
            for key, bad, total in evaluated:
                dq = self._samples.get(key)
                if dq is None:
                    dq = self._samples[key] = collections.deque(
                        maxlen=self._health_policy.window
                    )
                dq.append((bad, total))
                action = self._judge_locked(key)
                if action is not None:
                    actions.append(action)
        for action in actions:
            self._act(action)

    def _record_failure_sample(self, key, frames: int = 1) -> None:
        """Fold one FAILED dispatch of ``key`` into its health window as
        ``frames`` all-bad frames, and execute any resulting trip action
        — the same judge/act path a probe takes, so load-dead versions
        trip, roll back, and resolve canaries exactly like NaN ones.
        ``frames`` is the dispatch's frame count: healthy probes weigh
        bucket-size frames, so a failure weighed (1, 1) would be diluted
        ~bucket-fold at large buckets and an intermittently load-dead
        scene could never reach ``trip_bad_frac``."""
        frames = max(1, int(frames))
        self._m_probe_frames.inc(frames, scene=key[0], version=key[1])
        self._m_bad_frames.inc(frames, scene=key[0], version=key[1])
        with self._health_lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = collections.deque(
                    maxlen=self._health_policy.window
                )
            dq.append((frames, frames))
            action = self._judge_locked(key)
        if action is not None:
            self._act(action)

    def _judge_locked(self, key):
        """Breaker/canary verdict for ``key`` after a new sample (health
        lock held).  Mutates trip/canary STATE here — single-shot, so
        racing drains cannot double-act — and returns the pointer/cache
        action to execute outside the lock, or None."""
        pol = self._health_policy
        scene, version = key
        dq = self._samples[key]
        tot = sum(t for _, t in dq)
        bad = sum(b for b, _ in dq)
        frac = (bad / tot) if tot else 0.0
        canary = self._canaries.get(scene)
        is_canary = canary is not None and canary["version"] == version
        if (key not in self._tripped and tot >= pol.min_samples
                and frac >= pol.trip_bad_frac):
            self._tripped[key] = (
                f"{bad}/{tot} unhealthy winner frames "
                f"(bad_frac {frac:.2f} >= {pol.trip_bad_frac})"
            )
            if is_canary:
                del self._canaries[scene]
                return {"kind": "canary_rollback", "scene": scene,
                        "version": version, "bad_frac": frac,
                        "incumbent": canary["incumbent"]}
            try:
                active = self.manifest.active_version(scene)
            except ManifestError:
                active = None
            prev = self.manifest.previous_version(scene)
            if (version == active and pol.auto_rollback and prev is not None
                    and (scene, prev) not in self._tripped):
                return {"kind": "auto_rollback", "scene": scene,
                        "version": version, "bad_frac": frac}
            return {"kind": "tripped", "scene": scene, "version": version,
                    "bad_frac": frac}
        if is_canary and tot >= pol.canary_min_samples:
            idq = self._samples.get((scene, canary["incumbent"]))
            itot = sum(t for _, t in idq) if idq else 0
            ibad = sum(b for b, _ in idq) if idq else 0
            ifrac = (ibad / itot) if itot else 0.0
            del self._canaries[scene]
            if frac <= ifrac + pol.canary_bad_slack:
                return {"kind": "canary_promote", "scene": scene,
                        "version": version, "bad_frac": frac,
                        "incumbent": canary["incumbent"],
                        "incumbent_bad_frac": ifrac}
            self._tripped[key] = (
                f"canary bad_frac {frac:.2f} > incumbent {ifrac:.2f} "
                f"+ slack {pol.canary_bad_slack}"
            )
            return {"kind": "canary_rollback", "scene": scene,
                    "version": version, "bad_frac": frac,
                    "incumbent": canary["incumbent"],
                    "incumbent_bad_frac": ifrac}
        return None

    def _act(self, action) -> None:
        """Execute one judged action (entered with the health lock NOT
        held; single-shot guaranteed by the state mutations
        _judge_locked already made).

        Release-race guard: a trip-derived
        POINTER move executes inside the same health-locked critical
        section as a tripped-state re-check — an operator's
        ``release_scene`` landing in the judge->act window (their "the
        fault is fixed" assertion) can therefore never be undone by a
        stale rollback; the race is recorded as a
        ``trip_release_raced`` event instead.  (health -> manifest is
        a committed lock-graph edge, so the nesting is sanctioned;
        SceneManifest.rollback is a pure in-memory pointer swap, not a
        blocking call.)  The cache PURGE stays outside the health lock
        (no health -> cache edge, by design) with its own last-instant
        re-check: a release that slips into that final window costs at
        most one cold reload of good weights on the next dispatch —
        never a pointer move, never wrong results."""
        kind = action.pop("kind")
        scene, version = action["scene"], action["version"]
        if kind in ("auto_rollback", "tripped", "canary_rollback"):
            rolled_entry = rollback_exc = None
            with self._health_lock:
                still_tripped = (scene, version) in self._tripped
                if still_tripped and kind == "auto_rollback":
                    try:
                        rolled_entry = self.manifest.rollback(scene)
                    except ManifestError as e:
                        rollback_exc = e
            if not still_tripped:
                self._record_event("trip_release_raced", **action)
                return
            if kind == "auto_rollback":
                if rollback_exc is not None:
                    # Raced with an operator pointer move: degrade to a
                    # plain trip record — the version stays shed.
                    self._record_event(
                        "tripped", note=f"rollback lost: {rollback_exc}",
                        **action)
                else:
                    self._record_event("auto_rollback",
                                       to_version=rolled_entry.version,
                                       **action)
            else:
                self._record_event(kind, **action)
            if self._health_policy.evict_on_trip:
                with self._health_lock:
                    still_tripped = (scene, version) in self._tripped
                if still_tripped:
                    self.cache.evict((scene, version))
            return
        if kind == "canary_promote":
            try:
                self.manifest.promote(scene, version)
                self._record_event("canary_promoted", **action)
            except ManifestError as e:
                self._record_event("canary_rollback",
                                   note=f"finalize lost: {e}", **action)
                if self._health_policy.evict_on_trip:
                    self.cache.evict((scene, version))

    def _record_event(self, kind: str, **fields) -> None:
        t = self._clock()
        with self._health_lock:
            # Counter and event log move in the same critical section —
            # a monitor snapshot must never see the counter ahead of the
            # events list (the dispatcher's _count_* convention).
            self._m_health_events.inc(event=kind)
            self.health_events.append({
                "t": t, "event": kind, **fields,
            })
        # Causal tracing: breaker/canary actions judged
        # DURING a traced dispatch (deferred probes run between
        # dispatches, in the worker thread) nest as event spans under
        # that dispatch's traces.  Outside the lock — lockless appends,
        # and the common untraced path pays one contextvar read.
        for tr in active_traces():
            tr.add_event(f"scene_health:{kind}", time.perf_counter(),
                         **{k: str(v) for k, v in fields.items()})

    def _health_collector(self) -> dict:
        """The obs pull collector behind ``scene_health``: the same
        locked :meth:`health` snapshot, WITHOUT draining probes — a
        monitor scrape must stay read-only and never execute breaker
        actions on behalf of the serving threads."""
        if self._health_policy is None:
            return {"scenes": {}, "canaries": {}, "events": []}
        return self.health(drain=False)

    def bind_obs(self, metrics: MetricsRegistry) -> None:
        """Adopt this registry's health instruments + collectors into
        ``metrics`` (a dispatcher's obs registry), so ONE snapshot
        covers serve accounting, scene health and the weight cache.
        The instrument OBJECTS are
        shared, not copied — both registries read the same counts.
        Idempotent; also safe across several dispatchers over one
        SceneRegistry (each adopts the same objects)."""
        if metrics is self.obs:
            return
        metrics.register(self._m_probe_frames)
        metrics.register(self._m_bad_frames)
        metrics.register(self._m_health_events)
        metrics.register_collector("scene_health", self._health_collector)
        self.cache.bind_obs(metrics)

    def _resolve_serving(self, scene: str) -> SceneEntry:
        """Breaker- and canary-aware resolution: the manifest's active
        entry, unless a canary claims this dispatch; a resolved key whose
        breaker is OPEN sheds typed instead of serving known-bad
        weights."""
        entry = self.manifest.resolve(scene)
        with self._health_lock:
            canary = self._canaries.get(scene)
            canary_version = None
            if canary is not None:
                canary["count"] += 1
                n, f = canary["count"], canary["fraction"]
                if int(n * f) > int((n - 1) * f):
                    canary_version = canary["version"]
            key = (scene, canary_version) if canary_version is not None \
                else entry.key
            reason = self._tripped.get(key)
        if reason is not None:
            raise SceneUnhealthyError(
                f"scene {scene!r} v{key[1]} breaker is open ({reason}); "
                "release_scene() after the fault is fixed"
            )
        if canary_version is not None:
            return self.manifest.entry(scene, canary_version)
        return entry

    def compile_cache_size(self) -> int:
        """Distinct batch signatures across every bucket function -- the
        counterpart of the JAX package's compiled-program count, which the
        no-recompile tests pin (buckets used x bucket keys, however many
        scenes were swapped)."""
        with self._fns_lock:
            fns = list(self._fns.values())
        return sum(fn._cache_size() for fn in fns)

    def warm(self, scene_id: str) -> None:
        """Pre-stage a scene's active weights (cold-load off the hot path)."""
        self.cache.get(self.manifest.resolve(scene_id))

    def prewarm_programs(self, scene_id: str, frame_buckets,
                         route_ks=(None,)) -> int:
        """Run (once, on zero frames) every (K, frame-bucket) bucket
        function a scene's traffic -- including an SLO degradation ladder
        (``SLOPolicy.degrade_route_k``) -- can reach, OFF the hot path, so
        the first dispatch of each shape (cuDNN's algorithm choice, the
        allocator's growth) does not land on a request or look like a
        stall to the watchdog.  Zero batches carry per-frame ``seed`` leaves
        where the JAX package carries PRNG keys.  Returns the batch
        signature count afterwards."""
        entry = self.manifest.resolve(scene_id)
        params = self.cache.get(entry)
        H, W = entry.preset.height, entry.preset.width
        for k in route_ks:
            fn = self._fn_for(entry, k)
            for bucket in sorted(set(frame_buckets)):
                B = max(int(bucket), MIN_LANES)
                batch = {"seed": np.zeros(B, np.int64),
                         "image": np.zeros((B, H, W, 3), np.float32)}
                fn(params, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_cache_size()

    def dispatcher(self, cfg: RansacConfig = RansacConfig(),
                   start_worker: bool = True, **kw):
        """A scene-aware MicroBatchDispatcher over this registry, on the
        registry's device.  ``cfg`` carries the SERVING knobs (frame
        buckets, wait, depth) -- each scene's kernel still runs under its
        own manifest RansacConfig.  The registry's health instruments and
        cache stats are adopted into the dispatcher's obs registry, so
        ``disp.obs.snapshot()`` is the unified snapshot; the dispatcher
        keeps its own PRIVATE serve counters."""
        from esac_tpu_torch.serve.dispatcher import MicroBatchDispatcher

        kw.setdefault("device", self.device)
        disp = MicroBatchDispatcher(
            self.infer_fn(), cfg, start_worker=start_worker, **kw
        )
        self.bind_obs(disp.obs)
        return disp
