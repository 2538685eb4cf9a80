"""LRU device weight cache: scenes' param dicts in device memory under a byte
budget (the port of ``esac_tpu/registry/cache.py``, without its host tier).

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

The host tier below this cache (``tier=``) is not ported yet: only
``None`` is accepted.
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
    there); ``budget_bytes=None`` disables eviction.  Thread-safe, with the
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
        if tier is not None:
            raise ConfigError("the host weight tier is not ported yet: tier must be None")
        self._loader = loader
        self._budget = budget_bytes
        self._device = resolve_device(device)
        self._stage = stage if stage is not None else (
            lambda entry, host: to_device(host, self._device))
        self._lock = threading.Lock()
        self._trees: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
        self._nbytes: dict[Any, int] = {}
        # key -> in-flight load future: {"event", "result", "error"}.
        self._loading: dict[Any, dict] = {}
        # Bumped by clear(): a load that straddles a clear still resolves
        # its waiters but must NOT re-insert into a cache just emptied.
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self.disk_loads = 0
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
        fault records one weight_fault span per trace (read, then stage,
        or the coalesced wait on another worker's load)."""
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
            # eviction cannot turn a completed load into a miss.
            t0 = time.perf_counter() if traces else None
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
            host = self._loader(entry)
            t_read = time.perf_counter()
            tree = self._stage(entry, host)
            if traces:
                t_staged = time.perf_counter()
                for tr in traces:
                    tr.add_span(f"weight_fault:{key}", "weight_fault", t0, t_staged,
                                stages=[("read_disk", t_read - t0), ("stage", t_staged - t_read)],
                                key=str(key), source="disk", issuer=current_issuer(),
                                coalesced=False)
            with self._lock:
                # Do NOT cache a load that straddled clear() (generation
                # bumped) or an evict() of this key (a breaker trip racing
                # the load: caching would resurrect the purged weights).
                # The caller still gets the tree: in-flight dispatches drain
                # on the entry they resolved.
                if gen == self._gen and not fut.get("discard"):
                    self._trees[key] = tree
                    self._nbytes[key] = tree_nbytes(tree)
                    self._evict_to_budget()
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
            fut["event"].set()
            for tr in traces:
                tr.add_span(f"weight_fault:{key}", "weight_fault", t0, time.perf_counter(),
                            key=str(key), failed=True, error=type(e).__name__,
                            issuer=current_issuer())
            raise
        fut["event"].set()
        return tree

    def _evict_to_budget(self) -> None:
        """LRU-evict down to the byte budget (lock held)."""
        if self._budget is None:
            return
        while len(self._trees) > 1 and self._bytes_in_use() > self._budget:
            victim, _ = self._trees.popitem(last=False)
            del self._nbytes[victim]
            self.evictions.append(victim)
            self.evictions_total += 1

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
        """Drop one entry (e.g. a breaker-tripped version); True if it was
        resident.  A load of ``key`` in flight is not cached when it lands
        (its waiters still get their tree)."""
        with self._lock:
            found = key in self._trees
            if found:
                del self._trees[key]
                del self._nbytes[key]
                self.evictions.append(key)
                self.evictions_total += 1
            fut = self._loading.get(key)
            if fut is not None:
                fut["discard"] = True
        return found

    def clear(self) -> None:
        """Empty the cache.  In-flight loads still resolve their waiters but
        land in the NEW generation as misses -- a cleared cache stays
        cleared."""
        with self._lock:
            self._trees.clear()
            self._nbytes.clear()
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
                "disk_loads": self.disk_loads,
                "evictions": self.evictions_total,
                "resident": len(self._trees),
                "bytes_in_use": self._bytes_in_use(),
                "budget_bytes": self._budget,
                "load_failures": self.load_failures,
                "loads_in_flight": len(self._loading),
            }
