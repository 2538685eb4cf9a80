"""LRU device weight cache: scenes' param dicts in device memory under a byte
budget (the port of ``esac_tpu/registry/cache.py``).

Serving many scenes from one process means many weight sets contending for
one card's memory.  This cache holds the device-resident param dicts keyed
by ``(scene_id, version)`` (``SceneEntry.key``): a hit returns the already
staged dict (zero staging cost on the request path), a miss pays
``loader(entry)`` (the host load) + ``stage(entry, host)`` (the copy to the
device), and eviction is deterministic strict-LRU under ``budget_bytes``.

Invariants the serving layer relies on:

- **Cached params are never written.**  The bucket functions only read
  them (under ``torch.inference_mode``), so a dict is reused across
  dispatches as it is.
- **Deterministic eviction.**  Strict LRU over ``get`` order, measured in
  parameter, buffer and tensor bytes (:func:`tree_nbytes`); ``evictions``
  records the order.  The entry being inserted is never its own eviction
  victim: a single scene larger than the budget is admitted alone, with
  the overshoot visible in ``bytes_in_use``.
- **Eviction frees device memory.**  The cache drops its only reference;
  a dispatch that already holds the evicted dict keeps it alive until it
  returns (its tensors are freed then), so eviction never frees memory
  under a running computation.
- **Resolution happens at dispatch time.**  The cache is keyed by
  version, so a manifest promote simply starts missing on the new key; the
  old version ages out by LRU.

Tiered hierarchy: with a ``registry.hosttier.HostWeightTier`` attached
(``tier=``), this cache is the TOP of three levels (device memory ->
compressed host RAM -> disk):

- a miss first consults the host tier -- a host hit promotes by copying the
  payload to the card and decompressing it there (no disk IO, no checksum
  re-read: checksums were verified once on the disk -> host load);
- a disk load admits the compressed payload into the host tier and STAGES
  THE DECOMPRESSED PAYLOAD, not the raw read -- so the device bytes are
  identical whichever tier a scene arrived from (with
  ``compression="none"`` that is bit-identical to the raw read);
- LRU eviction DEMOTES instead of drops: the victim's retained payload
  object is re-admitted to the host tier (no recompression, no device
  sync -- the payload is immutable host memory);
- :meth:`DeviceWeightCache.evict` stays the PURGE path (breaker trips route
  here): the key leaves BOTH tiers -- known-bad weights must not survive in
  any tier.

Tier calls never happen under this cache's lock (victims are collected
locked and demoted outside), so there is no cache -> tier lock edge.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.obs.trace import active_traces, current_issuer
from esac_tpu_torch.registry.hosttier import decompress_tree
from esac_tpu_torch.serve.gate import demand, owning
from esac_tpu_torch.serve.slo import ConfigError
from esac_tpu_torch.utils.precision import resolve_device


def tree_nbytes(tree: Any) -> int:
    """Total bytes of a (host or device) param tree: every module's
    parameters and buffers, every tensor and array leaf."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in itertools.chain(tree.parameters(), tree.buffers()))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


def to_device(tree: Any, device: torch.device) -> Any:
    """Every tensor / array leaf of a nested dict / list tree as a tensor on
    ``device`` (the default staging of :class:`DeviceWeightCache`)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return torch.as_tensor(tree).to(device)
    return tree


class DeviceWeightCache:
    """Strict-LRU (scene, version) -> device param tree, byte-budgeted.

    ``loader(entry) -> host tree`` produces the weights
    (registry/serving.load_scene_params is the shipped loader);
    ``stage(entry, host) -> device tree`` copies them to ``device``
    (default :func:`to_device`; the registry builds the scene's modules
    there); ``budget_bytes=None`` disables eviction; ``tier`` is the host
    tier below (module docstring) or None.  Thread-safe, with the
    load OFF the instance lock: the lock covers lookup, insertion and
    eviction, while load + stage run under a per-key load future -- so
    concurrent dispatch workers cannot double-load a scene (waiters block
    on the owner's future), but one scene's slow, failing or stalled cold
    load cannot wedge every other scene's warm hit behind the cache lock.
    A failed load caches nothing -- the next request retries -- and is
    counted (``load_failures``).
    """

    def __init__(
        self,
        loader: Callable[[Any], Any],
        budget_bytes: int | None = None,
        device=None,
        tier=None,
        stage: Callable[[Any, Any], Any] | None = None,
    ):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes {budget_bytes} must be positive")
        self._loader = loader
        self._budget = budget_bytes
        self._device = resolve_device(device)
        self._stage = stage if stage is not None else (
            lambda entry, host: to_device(host, self._device))
        # The host-RAM tier below this cache, or None.  Immutable post-init.
        self.tier = tier
        self._lock = threading.Lock()
        self._trees: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
        self._nbytes: dict[Any, int] = {}
        # key -> the host-tier payload each resident tree was staged from:
        # demotion re-admits this exact immutable object.
        self._payloads: dict[Any, Any] = {}
        # key -> in-flight load future: {"event", "result", "error"}.
        self._loading: dict[Any, dict] = {}
        # Bumped by clear(): a load that straddles a clear still resolves
        # its waiters but must NOT re-insert into a cache just emptied.
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self.host_hits = 0    # misses promoted from the host tier
        self.disk_loads = 0   # misses that paid the full loader path
        self.demotions = 0    # LRU evictions re-admitted to the tier
        self.load_failures = 0
        # Bounded: the recent window is the record, the counter the total.
        self.evictions: collections.deque = collections.deque(maxlen=10_000)
        self.evictions_total = 0

    # ---- the request path ----

    def get(self, entry) -> Any:
        """Device param tree for ``entry`` (anything with a ``.key``); loads
        and stages on miss -- outside the lock, under a per-key future --
        evicting LRU entries until the budget holds.  When the running
        dispatch carries sampled traces (``obs.trace.active_traces``), a
        fault records one weight_fault span per trace (host-tier hit or disk
        read, then decompress + stage, or the coalesced wait on another
        worker's load)."""
        key = entry.key
        with self._lock:
            if key in self._trees:
                self.hits += 1
                self._trees.move_to_end(key)
                return self._trees[key]
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
        traces = active_traces()
        if not owner:
            # Another worker owns this key's load: wait for its future.  The
            # tree is handed over directly (not re-looked-up), so a racing
            # eviction cannot turn a completed load into a miss.  A demand
            # waiter marks the future demanded, so a prefetch owner stops
            # yielding to the dispatch that waits here (serve/gate.py).
            t0 = time.perf_counter() if traces else None
            if current_issuer() != "prefetch":
                demand(fut)
            fut["event"].wait()
            for tr in traces:
                tr.add_span(f"weight_fault:{key}", "weight_fault", t0, time.perf_counter(),
                            key=str(key), coalesced=True,
                            coalesced_with=fut.get("issuer", "demand"),
                            failed=fut["error"] is not None)
            if fut["error"] is not None:
                raise fut["error"]
            return fut["result"]
        t0 = time.perf_counter() if traces else None
        try:
            with owning(fut):
                host, payload, from_tier, t_payload = self._read_host(entry)
                tree = self._stage(entry, host)
            if traces:
                t_staged = time.perf_counter()
                stages = [("read_host" if from_tier else "read_disk", t_payload - t0),
                          ("decompress_stage", t_staged - t_payload)]
                for tr in traces:
                    tr.add_span(f"weight_fault:{key}", "weight_fault", t0, t_staged,
                                stages=list(stages), key=str(key),
                                source="host_tier" if from_tier else "disk",
                                issuer=current_issuer(), coalesced=False)
            with self._lock:
                # Do NOT cache a load that straddled clear() (generation
                # bumped) or an evict() of this key (a breaker trip racing
                # the load: caching would resurrect the purged weights).
                # The caller still gets the tree: in-flight dispatches drain
                # on the entry they resolved.
                if gen == self._gen and not fut.get("discard"):
                    self._trees[key] = tree
                    self._nbytes[key] = tree_nbytes(tree)
                    if payload is not None:
                        self._payloads[key] = payload
                    demoted = self._evict_to_budget()
                else:
                    demoted = []
                if from_tier:
                    self.host_hits += 1
                else:
                    self.disk_loads += 1
                fut["result"] = tree
                self._loading.pop(key, None)
        except BaseException as e:
            # ONE owner exit path for load, staging AND insertion faults: the
            # future resolves and every waiter wakes typed; a half-inserted
            # entry is rolled back so a later get retries from a clean miss.
            with self._lock:
                self.load_failures += 1
                fut["error"] = e
                self._loading.pop(key, None)
                self._trees.pop(key, None)
                self._nbytes.pop(key, None)
                self._payloads.pop(key, None)
            fut["event"].set()
            for tr in traces:
                tr.add_span(f"weight_fault:{key}", "weight_fault", t0, time.perf_counter(),
                            key=str(key), failed=True, error=type(e).__name__,
                            issuer=current_issuer())
            raise
        fut["event"].set()
        self._demote(demoted)
        return tree

    def _read_host(self, entry):
        """The owner's host-side read (NO cache lock held): ``(host tree,
        tier payload or None, from_tier, t_payload)``, ``t_payload`` stamping
        payload-in-hand.  With a tier, the tier is consulted first (a hit
        skips disk AND the checksum re-read), a miss pays the loader through
        the tier's per-key future (a prefetch racing this demand fault
        coalesces onto one disk read), and the tree handed to staging is
        ALWAYS the payload decompressed on this cache's device -- the device
        bytes are identical whichever tier the scene arrived from."""
        if self.tier is None:
            host = self._loader(entry)
            return host, None, False, time.perf_counter()
        hit = entry.key in self.tier
        payload = self.tier.get_or_load(
            entry.key, lambda: self.tier.compress(self._loader(entry)))
        t_payload = time.perf_counter()
        return decompress_tree(payload, self._device), payload, hit, t_payload

    def preload_host(self, entry) -> bool:
        """Stage ``entry`` into the HOST tier only (disk -> compressed RAM,
        no device staging) -- the prefetcher's second-tier admission.  Rides
        the tier's per-key future: concurrent callers (and the demand fault
        this predicts) share one disk read.  True if a load was needed,
        False when already resident in either tier."""
        if self.tier is None:
            raise ConfigError("preload_host needs a host tier attached")
        key = entry.key
        with self._lock:
            resident = key in self._trees
        if resident or key in self.tier:
            return False
        self.tier.get_or_load(key, lambda: self.tier.compress(self._loader(entry)))
        return True

    def _evict_to_budget(self) -> list:
        """LRU-evict down to the byte budget (lock held); returns the
        [(key, payload)] victims for the caller to demote into the host
        tier OUTSIDE the lock."""
        demoted = []
        if self._budget is None:
            return demoted
        while len(self._trees) > 1 and self._bytes_in_use() > self._budget:
            victim, _ = self._trees.popitem(last=False)
            del self._nbytes[victim]
            payload = self._payloads.pop(victim, None)
            if payload is not None:
                self.demotions += 1
                demoted.append((victim, payload))
            self.evictions.append(victim)
            self.evictions_total += 1
        return demoted

    def _demote(self, demoted: list) -> None:
        """Re-admit evicted entries' payloads to the host tier (NO cache lock
        held): host-memory pointer movement, no device sync, no
        recompression.  The device tensors are freed once no dispatch holds
        the evicted dict."""
        if self.tier is None:
            return
        for key, payload in demoted:
            self.tier.admit(key, payload)

    def demote(self, key) -> bool:
        """Explicitly push one entry down to the host tier (drop the device
        tree, re-admit the retained payload): the eviction path's semantics
        without byte pressure.  True if the key was device-resident."""
        with self._lock:
            if key not in self._trees:
                return False
            del self._trees[key]
            del self._nbytes[key]
            payload = self._payloads.pop(key, None)
            if payload is not None:
                self.demotions += 1
            self.evictions.append(key)
            self.evictions_total += 1
        if payload is not None:
            self._demote([(key, payload)])
        return True

    # ---- introspection / management ----

    def _bytes_in_use(self) -> int:
        """Byte total, lock held by the caller."""
        return sum(self._nbytes.values())

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes_in_use()

    def keys(self) -> list[Any]:
        """Resident keys, least-recently-used first (the eviction order)."""
        with self._lock:
            return list(self._trees)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._trees

    def __len__(self) -> int:
        with self._lock:
            return len(self._trees)

    def evict(self, key) -> bool:
        """PURGE one entry from the device level AND the host tier (e.g. a
        breaker-tripped version: known-bad weights must not survive in any
        tier); True if it was resident at either level.  A load of ``key``
        in flight is not cached when it lands (its waiters still get their
        tree).  LRU byte-pressure eviction demotes instead."""
        with self._lock:
            found = key in self._trees
            if found:
                del self._trees[key]
                del self._nbytes[key]
                self.evictions.append(key)
                self.evictions_total += 1
            self._payloads.pop(key, None)
            fut = self._loading.get(key)
            if fut is not None:
                fut["discard"] = True
        if self.tier is not None:
            # Outside the cache lock (no cache -> tier nesting).
            found = self.tier.evict(key) or found
        return found

    def clear(self) -> None:
        """Empty the DEVICE level.  In-flight loads still resolve their
        waiters but land in the NEW generation as misses -- a cleared cache
        stays cleared.  The host tier is untouched (it has its own
        ``clear``)."""
        with self._lock:
            self._trees.clear()
            self._nbytes.clear()
            self._payloads.clear()
            self._gen += 1

    def bind_obs(self, metrics, name: str = "weight_cache") -> None:
        """Publish :meth:`stats` into an obs ``MetricsRegistry`` as a pull
        collector.  Idempotent per (registry, name)."""
        metrics.register_collector(name, self.stats)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "host_hits": self.host_hits,
                "disk_loads": self.disk_loads,
                "demotions": self.demotions,
                "evictions": self.evictions_total,
                "resident": len(self._trees),
                "bytes_in_use": self._bytes_in_use(),
                "budget_bytes": self._budget,
                "load_failures": self.load_failures,
                "loads_in_flight": len(self._loading),
            }
