"""Host-RAM weight tier: compressed param trees between disk and the card
(the port of ``esac_tpu/registry/hosttier.py``).

The device weight cache (registry/cache.py) bounds device memory; this tier
bounds the *scene capacity of the process*: a scene demoted from the card
falls here, not back to disk.  The tier stores each (scene, version)'s
weights as one immutable compressed *payload*:

- **CNN leaves** (everything under the ``expert`` / ``gating`` subtrees)
  may be stored bf16 (``torch.bfloat16``, round to nearest even), or int8
  with a per-tensor scale (``maxabs / 127`` in float64, quantized by a
  float32 division and ``np.rint`` -- half to even -- in numpy, so the
  codec is the JAX package's bit for bit).
- **Geometry-critical leaves** (:data:`EXACT_KEYS` -- scene centers,
  principal point, focal: everything that reaches ``geometry/``) and any
  non-float32 leaf are kept byte-exact whatever the codec: a pose may see
  quantized *network* weights, never a perturbed camera.
- ``compression="none"`` stores every leaf byte-exact -- results are then
  bit-identical to loading from disk directly.

Payload leaves are CPU tensors, always real copies of the caller's leaves,
and nothing writes them after :func:`compress_tree` (torch has no read-only
tensors, so this is the module's contract, not a flag).  That is what makes
tier transitions exact: the device cache retains each resident entry's
payload and *demotion* re-admits that same object -- a demote -> promote
cycle never re-quantizes.  Promotion host -> device is
:func:`decompress_tree` with ``device=``: each leaf is copied to the card
in its STORED dtype and upcast there (bf16 -> float32 is exact; int8 times
the float32 scale is one IEEE multiply on either side), so the staged
weights equal a host-side decompression bit for bit while a bf16 payload
moves half the bytes of float32.  No disk IO, no checksum re-read.

Concurrency: the instance lock covers only the LRU table and counters;
compression, decompression and the producer of :meth:`get_or_load` run
OUTSIDE it under a per-key load future (the DeviceWeightCache.get idiom) --
one scene's stalled or failing disk read cannot wedge another scene's host
hit, a failed load caches nothing, and demand faults coalesce with
prefetches onto one disk read.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any

import numpy as np
import torch

from esac_tpu_torch.obs.trace import active_traces, current_issuer
from esac_tpu_torch.serve.gate import demand, owning, yield_to_dispatches
from esac_tpu_torch.serve.slo import ConfigError

# Top-level subtrees of a load_scene_params tree that hold CNN weights --
# the only leaves a lossy codec may touch.
CNN_KEYS = ("expert", "gating")

# Geometry-critical top-level leaves: kept byte-exact under every codec.
EXACT_KEYS = ("centers", "c", "f")

COMPRESSION_CODECS = ("none", "bf16", "int8")


class _CompressedLeaf:
    """One stored leaf: ``codec`` in {"f32", "bf16", "int8"}; ``data`` is
    the stored CPU tensor (the original dtype for "f32" -- the exact class
    keeps ints and odd dtypes as they are), ``scale`` the int8 per-tensor
    dequantization factor."""

    __slots__ = ("codec", "data", "scale")

    def __init__(self, codec: str, data: torch.Tensor, scale: float | None = None):
        self.codec = codec
        self.data = data
        self.scale = scale

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() + (8 if self.scale is not None
                                                                 else 0)


def _map_leaves(fn, node, lossy: bool):
    """Structure-preserving map over a host param tree (dicts / lists /
    tuples of tensor or array leaves).  ``lossy`` rides down the recursion:
    True only under the CNN subtrees.  Each leaf is one prefetch step
    (serve/gate.py)."""
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v, lossy) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(fn, v, lossy) for v in node)
    yield_to_dispatches()
    return fn(node, lossy)


def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.from_numpy(np.array(leaf))


def _compress_leaf(leaf, lossy: bool, codec: str) -> _CompressedLeaf:
    t = _host_tensor(leaf)
    if not lossy or codec == "none" or t.dtype != torch.float32:
        # Exact class: geometry leaves, integer/bool leaves, non-f32 floats
        # -- stored verbatim, ALWAYS as a real copy: a payload aliasing a
        # caller-mutable buffer would let a later mutation silently change
        # what a demote -> promote cycle stages.
        return _CompressedLeaf("f32", t.clone())
    if codec == "bf16":
        return _CompressedLeaf("bf16", t.to(torch.bfloat16))
    # int8 with a per-tensor scale: symmetric, scale = maxabs/127, in numpy
    # as the JAX package computes it (the float32 division by the float64
    # scale rounds there; a product with a reciprocal could land an ulp off).
    arr = t.numpy()
    maxabs = float(np.max(np.abs(arr))) if arr.size else 0.0
    if maxabs == 0.0:
        return _CompressedLeaf("int8", torch.zeros(tuple(arr.shape), dtype=torch.int8), 0.0)
    scale = maxabs / 127.0
    q = np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)
    return _CompressedLeaf("int8", torch.from_numpy(q), scale)


def _decompress_leaf(leaf: _CompressedLeaf, device) -> torch.Tensor:
    if leaf.codec == "f32":
        return leaf.data.to(device, copy=True)
    if leaf.codec == "bf16":
        return leaf.data.to(device).float()
    if leaf.scale == 0.0:
        return torch.zeros(tuple(leaf.data.shape), dtype=torch.float32, device=device)
    scale = torch.tensor(np.float32(leaf.scale), device=device)
    return leaf.data.to(device).float() * scale


def _payload_nbytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        else:
            total += node.nbytes
    return total


def compress_tree(tree: Any, compression: str) -> dict:
    """Host param tree (tensor or numpy leaves) -> immutable payload
    ``{"tree", "nbytes", "compression"}``.  Only float32 leaves under
    :data:`CNN_KEYS` subtrees are eligible for the lossy codec; everything
    else -- notably every :data:`EXACT_KEYS` geometry leaf -- is stored
    byte-exact."""
    if compression not in COMPRESSION_CODECS:
        raise ConfigError(f"compression {compression!r} not in {COMPRESSION_CODECS}")

    def leaf_fn(leaf, lossy):
        return _compress_leaf(leaf, lossy, compression)

    if not isinstance(tree, dict):
        out = _map_leaves(leaf_fn, tree, False)
    else:
        out = {k: _map_leaves(leaf_fn, v, k in CNN_KEYS) for k, v in tree.items()}
    return {"tree": out, "nbytes": _payload_nbytes(out), "compression": compression}


def decompress_tree(payload: dict, device="cpu") -> Any:
    """Payload -> tree of float32 (lossy) or stored-dtype (exact) tensors on
    ``device``, each a fresh tensor (the payload is never handed out).
    Deterministic per payload: a payload decompresses to the same bytes
    every time, on the CPU and on the card alike, which is what makes every
    tier transition serve identical weights."""
    dev = torch.device(device)

    def leaf_fn(leaf, _lossy):
        return _decompress_leaf(leaf, dev)

    return _map_leaves(leaf_fn, payload["tree"], False)


class HostWeightTier:
    """Byte-budgeted strict-LRU (scene, version) -> compressed payload.

    ``budget_bytes=None`` disables eviction.  :meth:`get_or_load` is the
    read path shared by demand faults and prefetches: a hit returns the
    resident payload; a miss runs ``producer()`` (disk read + compress)
    OUTSIDE the lock under a per-key future so concurrent callers -- a
    prefetch racing the demand fault it predicted -- coalesce onto one
    disk read and a failure caches nothing.  :meth:`admit` is the demotion
    path: the device cache re-admits the payload object it retained, so no
    recompression ever happens.
    """

    def __init__(self, budget_bytes: int | None = None, compression: str = "bf16"):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes {budget_bytes} must be positive")
        if compression not in COMPRESSION_CODECS:
            raise ValueError(f"compression {compression!r} not in {COMPRESSION_CODECS}")
        self.compression = compression
        self._budget = budget_bytes
        self._lock = threading.Lock()
        self._payloads: "collections.OrderedDict[Any, dict]" = collections.OrderedDict()
        # key -> in-flight load future: {"event", "result", "error"}.
        self._loading: dict[Any, dict] = {}
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.load_failures = 0
        self.purges = 0
        self.evictions: collections.deque = collections.deque(maxlen=10_000)
        self.evictions_total = 0

    def compress(self, host_tree: Any) -> dict:
        """Compress with this tier's codec (pure -- no lock, no state)."""
        return compress_tree(host_tree, self.compression)

    # ---- the read path ----

    def get_or_load(self, key, producer=None) -> dict | None:
        """Resident payload for ``key``; on a miss, ``producer() ->
        payload`` fills it (None producer = peek: a miss returns None).  The
        producer runs OUTSIDE the lock under a per-key future: waiters get
        the owner's payload directly, a raising producer resolves every
        waiter typed and caches nothing."""
        with self._lock:
            payload = self._payloads.get(key)
            if payload is not None:
                self.hits += 1
                self._payloads.move_to_end(key)
                return payload
            if producer is None:
                self.misses += 1
                return None
            fut = self._loading.get(key)
            if fut is None:
                fut = self._loading[key] = {
                    "event": threading.Event(), "result": None, "error": None,
                    "issuer": current_issuer(),
                }
                owner = True
            else:
                owner = False
            self.misses += 1
            gen = self._gen
        if not owner:
            # Coalesced onto another issuer's in-flight disk read: a traced
            # dispatch riding the prefetcher's read records the event.
            traces = active_traces()
            if traces and fut.get("issuer") == "prefetch":
                t = time.perf_counter()
                for tr in traces:
                    tr.add_event("prefetch_coalesced", t, key=str(key))
            if current_issuer() != "prefetch":
                demand(fut)  # the owner stops yielding to this waiter
            fut["event"].wait()
            if fut["error"] is not None:
                raise fut["error"]
            return fut["result"]
        try:
            with owning(fut):
                payload = producer()
            with self._lock:
                # Not cached when clear() bumped the generation or evict()
                # purged this key mid-load (a breaker trip must never be
                # undone by the load it raced).  Waiters still get it.
                if gen == self._gen and not fut.get("discard"):
                    self._admit_locked(key, payload)
                fut["result"] = payload
                self._loading.pop(key, None)
        except BaseException as e:
            # One owner exit path: the future resolves typed, nothing is
            # cached, the next call retries.
            with self._lock:
                self.load_failures += 1
                fut["error"] = e
                self._loading.pop(key, None)
                self._payloads.pop(key, None)
            fut["event"].set()
            raise
        fut["event"].set()
        return payload

    # ---- admission / demotion ----

    def admit(self, key, payload: dict) -> None:
        """Insert (or LRU-touch) ``key``'s payload -- the device cache's
        demotion path.  Re-admitting a resident key only touches recency
        (payloads are immutable; there is nothing to update)."""
        with self._lock:
            self._admit_locked(key, payload)

    def _admit_locked(self, key, payload: dict) -> None:
        if key in self._payloads:
            self._payloads.move_to_end(key)
            return
        self._payloads[key] = payload
        self.admissions += 1
        if self._budget is None:
            return
        # Strict LRU under the byte budget; the entry being inserted is
        # never its own victim.
        while len(self._payloads) > 1 and self._bytes_locked() > self._budget:
            victim, _ = self._payloads.popitem(last=False)
            self.evictions.append(victim)
            self.evictions_total += 1

    # ---- management ----

    def evict(self, key) -> bool:
        """Purge one entry (a tripped version's weights must leave BOTH
        tiers -- the registry's breaker routes here via the device cache);
        True if it was resident."""
        with self._lock:
            fut = self._loading.get(key)
            if fut is not None:
                fut["discard"] = True  # an in-flight load must not re-admit
            if key not in self._payloads:
                return False
            del self._payloads[key]
            self.purges += 1
            return True

    def clear(self) -> None:
        """Empty the tier; in-flight loads still resolve their waiters but
        land in the new generation (the cache.clear contract)."""
        with self._lock:
            self._payloads.clear()
            self._gen += 1

    def keys(self) -> list[Any]:
        """Resident keys, least-recently-used first."""
        with self._lock:
            return list(self._payloads)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._payloads

    def __len__(self) -> int:
        with self._lock:
            return len(self._payloads)

    def _bytes_locked(self) -> int:
        return sum(p["nbytes"] for p in self._payloads.values())

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes_locked()

    def bind_obs(self, metrics, name: str = "host_tier") -> None:
        """Publish :meth:`stats` into an obs ``MetricsRegistry`` as a pull
        collector."""
        metrics.register_collector(name, self.stats)

    def stats(self) -> dict:
        with self._lock:
            return {
                "compression": self.compression,
                "hits": self.hits,
                "misses": self.misses,
                "admissions": self.admissions,
                "evictions": self.evictions_total,
                "purges": self.purges,
                "resident": len(self._payloads),
                "bytes_in_use": self._bytes_locked(),
                "budget_bytes": self._budget,
                "load_failures": self.load_failures,
                "loads_in_flight": len(self._loading),
            }
