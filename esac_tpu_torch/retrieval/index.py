"""Scene prototype index: the retrieval analogue of the manifest (the port
of ``esac_tpu/retrieval/index.py``).

A fixed-capacity slot table of per-scene prototype embeddings, padded to
``RetrievalConfig.max_scenes`` and masked -- the table rides the one
retrieval forward as tensor ARGUMENTS, so ``enroll`` / ``remove`` never
change its batch signature.

Concurrency: all mutable state lives under the one instance lock, a leaf
-- ``snapshot`` copies the arrays under the lock and the forward runs
entirely outside it; prototype math (means, norms) runs before the lock is
taken.
"""

from __future__ import annotations

import threading

import numpy as np

from esac_tpu_torch.registry.manifest import ManifestError


class SceneIndex:
    """Slot table: scene_id -> (prototype row, mask bit).

    ``capacity`` is the static prototype axis; enrolling past it raises
    :class:`ManifestError` (a deterministic config fault, exactly like
    registering past a manifest's shape contract).  Re-enrolling an
    existing scene updates its prototype in place, keeping its slot.
    """

    def __init__(self, capacity: int, embed_dim: int):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        if embed_dim < 1:
            raise ValueError(f"embed_dim {embed_dim} < 1")
        self.capacity = int(capacity)
        self.embed_dim = int(embed_dim)
        self._lock = threading.Lock()
        self._slots: dict[str, int] = {}           # scene_id -> slot
        self._ids: list[str | None] = [None] * self.capacity
        self._prototypes = np.zeros((self.capacity, self.embed_dim),
                                    np.float32)
        self._mask = np.zeros((self.capacity,), np.bool_)
        self._enrollments = 0
        self._removals = 0

    @staticmethod
    def _prototype_of(embeddings) -> np.ndarray:
        """Mean-then-renormalize prototype from one scene's view
        embeddings ((n, D) or (D,)) — pure host math, run BEFORE the
        lock."""
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim == 1:
            emb = emb[None, :]
        proto = emb.mean(axis=0)
        norm = float(np.sqrt(float(proto @ proto) + 1e-12))
        return proto / norm

    def enroll(self, scene_id: str, embeddings) -> int:
        """Install (or refresh) ``scene_id``'s prototype; returns its
        slot.  Raises :class:`ManifestError` when the padded axis is
        full — growing ``max_scenes`` is a config change, never an
        implicit new signature."""
        proto = self._prototype_of(embeddings)
        if proto.shape != (self.embed_dim,):
            raise ManifestError(
                f"embedding dim {proto.shape} != ({self.embed_dim},) for "
                f"scene {scene_id!r}"
            )
        with self._lock:
            slot = self._slots.get(scene_id)
            if slot is None:
                free = next(
                    (i for i, sid in enumerate(self._ids) if sid is None),
                    None,
                )
                if free is None:
                    raise ManifestError(
                        f"scene index full ({self.capacity} slots) "
                        f"enrolling {scene_id!r}; raise "
                        "RetrievalConfig.max_scenes (a new batch signature)"
                    )
                slot = free
                self._slots[scene_id] = slot
                self._ids[slot] = scene_id
            self._prototypes[slot] = proto
            self._mask[slot] = True
            self._enrollments += 1
            return slot

    def remove(self, scene_id: str) -> bool:
        """Mask ``scene_id`` out of the table (frees its slot).
        Idempotent; returns whether anything was removed."""
        with self._lock:
            slot = self._slots.pop(scene_id, None)
            if slot is None:
                return False
            self._ids[slot] = None
            self._mask[slot] = False
            self._prototypes[slot] = 0.0
            self._removals += 1
            return True

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, tuple]:
        """(prototypes copy, mask copy, slot ids tuple) — the tensor
        arguments of one retrieval dispatch, consistent under the
        lock; the dispatch itself happens outside it."""
        with self._lock:
            return (self._prototypes.copy(), self._mask.copy(),
                    tuple(self._ids))

    def scene_ids(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sid for sid in self._ids if sid is not None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "embed_dim": self.embed_dim,
                "enrolled": len(self._slots),
                "enrollments": self._enrollments,
                "removals": self._removals,
            }
