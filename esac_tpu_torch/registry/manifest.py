"""Versioned multi-scene manifest: which weights serve which scene (the port
of ``esac_tpu/registry/manifest.py``; its JSON is the JAX package's, byte
for byte).

For every scene id the manifest records one or more immutable versioned
:class:`SceneEntry` rows -- expert / gating checkpoint paths (the
``utils/checkpoint.py`` layout), the scene's
:class:`~esac_tpu_torch.ransac.config.RansacConfig`, and a
:class:`ScenePreset` shape/architecture signature -- plus which version is
*active*.  Two design rules keep serving cheap and rollouts safe:

- **The preset is the bucket key.**  Everything that changes a dispatch's
  shapes or modules (image size, expert count, net widths, compute dtype,
  gating presence) lives in the frozen, hashable ``ScenePreset``;
  everything that does NOT (the actual weights, the scene center, the
  camera intrinsics) rides the device param dict as arguments
  (registry/serving.py).  Scenes sharing a (preset, ransac) pair share one
  bucket function, and hot-swapping between them adds no batch signature.
- **Promote/rollback are atomic pointer swaps.**  ``promote`` only moves
  the ``active`` pointer (under the manifest lock) after validating the
  target version exists; the previous pointer is kept for one-step
  ``rollback``.  Entries are immutable, so a dispatch that already
  resolved its entry keeps serving the old weights until it completes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import threading
from typing import Any

import numpy as np
import torch

from esac_tpu_torch.ransac.config import RansacConfig

FORMAT_VERSION = 1

# Entry-level schema version: bumped when a SceneEntry grows fields whose
# *absence of understanding* would change serving semantics.  v1 = the
# first shape; v2 adds content ``checksums`` + this field.  A reader
# REJECTS entries declaring a newer schema (forward-compat rejection: a
# manifest written by a newer writer may carry semantics —
# e.g. a different checksum algorithm — this reader cannot verify, and
# silently serving it is exactly the corrupt-scene hazard the checksums
# exist to close).  Older manifests without the field hydrate with the
# default and keep working (checksums stay optional).
SCHEMA_VERSION = 2

# Checkpoint roles a SceneEntry checksum may cover.
CHECKSUM_ROLES = ("expert", "gating")


class ManifestError(ValueError):
    """A manifest (or one of its entries/checkpoints) failed validation.
    Deterministic: retrying cannot fix a malformed entry."""

    retryable = False
    wire_name = "manifest"


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    """Shape/architecture signature of a scene: image size, expert count,
    net widths, compute dtype and gating presence.  Scenes with equal
    presets share one bucket function; their weights differ only as
    arguments."""

    height: int
    width: int
    num_experts: int
    stem_channels: tuple[int, ...] = (64, 128, 256)
    head_channels: int = 512
    head_depth: int = 4
    gating_channels: tuple[int, ...] = (32, 64, 128, 256)
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    gated: bool = True
    # Fixed by the ExpertNet architecture (three stride-2 stages).
    stride: int = 8

    def __post_init__(self):
        if self.height % self.stride or self.width % self.stride:
            raise ManifestError(
                f"preset {self.height}x{self.width} not divisible by "
                f"stride {self.stride}"
            )
        if self.num_experts < 1:
            raise ManifestError(f"num_experts {self.num_experts} < 1")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ManifestError(f"unknown compute_dtype {self.compute_dtype!r}")
        object.__setattr__(self, "stem_channels", tuple(self.stem_channels))
        object.__setattr__(self, "gating_channels", tuple(self.gating_channels))

    @property
    def n_cells(self) -> int:
        return (self.height // self.stride) * (self.width // self.stride)


@dataclasses.dataclass(frozen=True)
class SceneEntry:
    """One immutable (scene, version) row of the manifest.

    ``checksums`` (schema v2) pins the checkpoint CONTENT this entry was
    authored against: sorted ``(role, sha256-hex)`` pairs over the loaded
    param tree + config sidecar (:func:`params_checksum`), verified by
    ``registry.serving.load_scene_params`` at load time so a corrupt or
    swapped checkpoint becomes a typed ``ChecksumMismatchError`` instead
    of silently-garbage poses.  ``None`` disables verification (legacy
    entries).  ``schema_version`` records the writer's entry schema; see
    ``SCHEMA_VERSION`` for the forward-compat rejection rule.
    """

    scene_id: str
    version: int
    expert_ckpt: str
    preset: ScenePreset
    gating_ckpt: str | None = None
    ransac: RansacConfig = RansacConfig()
    checksums: tuple[tuple[str, str], ...] | None = None
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if not self.scene_id or not isinstance(self.scene_id, str):
            raise ManifestError(f"bad scene_id {self.scene_id!r}")
        # Strict int: a bool/float version (JSON `true` / `1.5`) used to
        # hydrate by silent int() truncation — a version pointer that does
        # not round-trip exactly is malformed, not approximately right.
        if isinstance(self.version, bool) or not isinstance(self.version, int):
            raise ManifestError(
                f"{self.scene_id}: version {self.version!r} must be an "
                "exact integer"
            )
        if self.version < 1:
            raise ManifestError(
                f"{self.scene_id}: version {self.version} < 1"
            )
        sv = self.schema_version
        if isinstance(sv, bool) or not isinstance(sv, int) or sv < 1:
            raise ManifestError(
                f"{self.scene_id} v{self.version}: schema_version {sv!r} "
                "must be an integer >= 1"
            )
        if sv > SCHEMA_VERSION:
            raise ManifestError(
                f"{self.scene_id} v{self.version}: entry schema_version "
                f"{sv} is newer than this reader's {SCHEMA_VERSION} — the "
                "manifest was written by a newer writer; refusing to "
                "serve semantics this reader cannot verify"
            )
        object.__setattr__(
            self, "checksums", _normalize_checksums(self)
        )
        if self.preset.gated != (self.gating_ckpt is not None):
            raise ManifestError(
                f"{self.scene_id} v{self.version}: preset.gated="
                f"{self.preset.gated} but gating_ckpt="
                f"{self.gating_ckpt!r} — a gated scene needs a gating "
                "checkpoint and vice versa"
            )

    @property
    def checksum_map(self) -> dict[str, str]:
        """``{role: sha256-hex}`` view of ``checksums`` ({} when unset)."""
        return dict(self.checksums) if self.checksums else {}

    @property
    def key(self) -> tuple[str, int]:
        """Device weight-cache key: (scene id, version)."""
        return (self.scene_id, self.version)

    def bucket_key(self) -> tuple[ScenePreset, RansacConfig]:
        """Bucket-function family key: scenes sharing it are served by the
        same bucket functions when hot-swapped (registry/serving.py builds
        one per bucket key; params are arguments)."""
        return (self.preset, self.ransac)


def _normalize_checksums(entry: "SceneEntry"):
    """Validate + canonicalize an entry's ``checksums`` field: sorted
    tuple of (role, 64-hex-sha256) string pairs (JSON round-trips the
    inner pairs as lists), roles limited to the entry's checkpoints."""
    raw = entry.checksums
    if raw is None:
        return None
    what = f"{entry.scene_id} v{entry.version}"
    if isinstance(raw, dict):
        raw = sorted(raw.items())
    try:
        items = [tuple(item) for item in raw]
    except TypeError:
        raise ManifestError(
            f"{what}: checksums must be (role, sha256) pairs, got {raw!r}"
        ) from None
    out = []
    for item in items:
        if len(item) != 2 or not all(isinstance(x, str) for x in item):
            raise ManifestError(
                f"{what}: checksum entry {item!r} is not a "
                "(role, sha256-hex) string pair"
            )
        role, digest = item
        if role not in CHECKSUM_ROLES:
            raise ManifestError(
                f"{what}: unknown checksum role {role!r} "
                f"(valid: {CHECKSUM_ROLES})"
            )
        if role == "gating" and entry.gating_ckpt is None:
            raise ManifestError(
                f"{what}: gating checksum on an ungated entry"
            )
        if len(digest) != 64 or any(
            c not in "0123456789abcdef" for c in digest.lower()
        ):
            raise ManifestError(
                f"{what}: checksum for {role!r} is not 64-hex sha256: "
                f"{digest!r}"
            )
        out.append((role, digest.lower()))
    if len({r for r, _ in out}) != len(out):
        raise ManifestError(f"{what}: duplicate checksum role")
    return tuple(sorted(out))


def params_checksum(params: Any, config: dict | None = None) -> str:
    """Content sha256 of a LOADED checkpoint: every array leaf of the
    param tree (deterministic sorted-key traversal: path + shape + dtype
    + raw bytes) plus the canonical-JSON config sidecar.

    Hashing the loaded values -- not the on-disk files -- makes the digest
    independent of the file layout and places verification AFTER the whole
    read path, so corruption anywhere between disk and host memory is
    caught.  Torch tensor leaves hash as their host numpy arrays
    (``.cpu().numpy()``), so one numpy tree gives the same digest here and
    in the JAX package.
    """
    h = hashlib.sha256()

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            if isinstance(node, torch.Tensor):
                node = node.detach().cpu().numpy()
            arr = np.asarray(node)
            h.update(prefix.encode())
            h.update(f"|{arr.shape}|{arr.dtype.str}|".encode())
            h.update(np.ascontiguousarray(arr).tobytes())

    walk("", params)
    if config is not None:
        h.update(b"||config||")
        h.update(json.dumps(config, sort_keys=True).encode())
    return h.hexdigest()


# ---------------- (de)serialization ----------------

def _dataclass_from_dict(cls, data: dict, what: str):
    """Strict dataclass hydration: unknown keys are rejected (a manifest
    field the reader does not understand must fail loudly, not silently
    drop semantics), tuples survive the JSON list round-trip."""
    if not isinstance(data, dict):
        raise ManifestError(f"{what}: expected an object, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ManifestError(f"{what}: unknown field(s) {sorted(unknown)}")
    kw = {}
    for name, value in data.items():
        if isinstance(value, list):
            value = tuple(value)
        kw[name] = value
    try:
        return cls(**kw)
    except ManifestError:
        raise
    except (TypeError, ValueError) as e:
        raise ManifestError(f"{what}: {e}") from e


def entry_to_dict(entry: SceneEntry) -> dict:
    d = dataclasses.asdict(entry)
    d["preset"] = dataclasses.asdict(entry.preset)
    d["ransac"] = dataclasses.asdict(entry.ransac)
    return d


def entry_from_dict(data: dict, what: str = "entry") -> SceneEntry:
    if not isinstance(data, dict):
        raise ManifestError(f"{what}: expected an object")
    data = dict(data)
    preset = _dataclass_from_dict(
        ScenePreset, data.pop("preset", None), f"{what}.preset"
    )
    ransac = _dataclass_from_dict(
        RansacConfig, data.pop("ransac", {}), f"{what}.ransac"
    )
    return _dataclass_from_dict(
        SceneEntry, {**data, "preset": preset, "ransac": ransac}, what
    )


class SceneManifest:
    """The versioned scene table + active/previous pointers.

    Thread-safe: ``resolve`` races ``promote``/``rollback`` by design (the
    dispatcher worker resolves per dispatch while an operator promotes), so
    pointer reads and swaps share one lock.  Entries themselves are frozen
    dataclasses — once resolved, an entry cannot change under a dispatch.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, int], SceneEntry] = {}
        self._active: dict[str, int] = {}
        self._previous: dict[str, int] = {}

    # ---- authoring ----

    def add(self, entry: SceneEntry, activate: bool = True) -> SceneEntry:
        """Register an immutable (scene, version) row.  The first version of
        a scene activates automatically; later ones only with ``activate``
        (otherwise they stage for a later :meth:`promote`)."""
        with self._lock:
            if entry.key in self._entries:
                raise ManifestError(
                    f"duplicate entry {entry.key}: versions are immutable — "
                    "register a new version instead"
                )
            self._entries[entry.key] = entry
            if activate or entry.scene_id not in self._active:
                if entry.scene_id in self._active:
                    self._previous[entry.scene_id] = self._active[entry.scene_id]
                self._active[entry.scene_id] = entry.version
        return entry

    # ---- serving-plane reads ----

    def scene_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._active)

    def versions(self, scene_id: str) -> list[int]:
        with self._lock:
            return sorted(v for (s, v) in self._entries if s == scene_id)

    def resolve(self, scene_id: str) -> SceneEntry:
        """Active entry for a scene — called once per dispatch, so a promote
        lands between dispatches, never inside one."""
        with self._lock:
            try:
                return self._entries[(scene_id, self._active[scene_id])]
            except KeyError:
                raise ManifestError(f"unknown scene {scene_id!r}") from None

    def entry(self, scene_id: str, version: int) -> SceneEntry:
        """A specific registered (scene, version) row — the canary
        resolution path (registry.serving routes a traffic fraction to a
        NOT-yet-active version without moving the active pointer)."""
        with self._lock:
            try:
                return self._entries[(scene_id, version)]
            except KeyError:
                raise ManifestError(
                    f"no entry {scene_id!r} v{version}"
                ) from None

    def active_version(self, scene_id: str) -> int:
        with self._lock:
            try:
                return self._active[scene_id]
            except KeyError:
                raise ManifestError(f"unknown scene {scene_id!r}") from None

    def previous_version(self, scene_id: str) -> int | None:
        """The one-step rollback target, or None (no last-known-good)."""
        with self._lock:
            return self._previous.get(scene_id)

    # ---- rollout ----

    def promote(self, scene_id: str, version: int) -> SceneEntry:
        """Atomically point a scene at ``version``.  In-flight dispatches
        keep the entry they already resolved (entries are immutable); every
        later dispatch resolves the new version."""
        with self._lock:
            entry = self._entries.get((scene_id, version))
            if entry is None:
                raise ManifestError(
                    f"cannot promote {scene_id!r} to unregistered "
                    f"version {version}"
                )
            current = self._active.get(scene_id)
            if current is not None and current != version:
                self._previous[scene_id] = current
            self._active[scene_id] = version
            return entry

    def rollback(self, scene_id: str) -> SceneEntry:
        """One-step undo of the last promote (pointer swap, same drain
        semantics)."""
        with self._lock:
            prev = self._previous.get(scene_id)
            if prev is None:
                raise ManifestError(f"{scene_id!r}: nothing to roll back to")
            self._previous[scene_id] = self._active[scene_id]
            self._active[scene_id] = prev
            return self._entries[(scene_id, prev)]

    # ---- validation / persistence ----

    def validate(self, check_paths: bool = False) -> None:
        with self._lock:
            for sid, ver in self._active.items():
                if (sid, ver) not in self._entries:
                    raise ManifestError(
                        f"active pointer {sid!r} -> v{ver} has no entry"
                    )
            for sid, ver in self._previous.items():
                if (sid, ver) not in self._entries:
                    raise ManifestError(
                        f"previous pointer {sid!r} -> v{ver} has no entry"
                    )
            entries = list(self._entries.values())
        if check_paths:
            for e in entries:
                paths = [e.expert_ckpt] + (
                    [e.gating_ckpt] if e.gating_ckpt else []
                )
                for p in paths:
                    if not (pathlib.Path(p) / "config.json").exists():
                        raise ManifestError(
                            f"{e.scene_id} v{e.version}: checkpoint "
                            f"{p!r} missing or not a utils/checkpoint dir"
                        )

    def to_dict(self) -> dict:
        with self._lock:
            scenes: dict[str, Any] = {}
            for (sid, ver), entry in sorted(self._entries.items()):
                rec = scenes.setdefault(
                    sid, {"active": self._active.get(sid), "versions": {}}
                )
                if sid in self._previous:
                    rec["previous"] = self._previous[sid]
                rec["versions"][str(ver)] = entry_to_dict(entry)
            return {"format_version": FORMAT_VERSION, "scenes": scenes}

    @classmethod
    def from_dict(cls, data: dict) -> "SceneManifest":
        if not isinstance(data, dict):
            raise ManifestError("manifest: expected a JSON object")
        if data.get("format_version") != FORMAT_VERSION:
            raise ManifestError(
                f"manifest format_version {data.get('format_version')!r} "
                f"!= {FORMAT_VERSION}"
            )
        unknown = set(data) - {"format_version", "scenes"}
        if unknown:
            raise ManifestError(
                f"manifest: unknown field(s) {sorted(unknown)} — written "
                "by a newer writer?  This reader supports format_version "
                f"{FORMAT_VERSION} / entry schema_version <= {SCHEMA_VERSION}"
            )
        m = cls()
        if "scenes" not in data:
            raise ManifestError("manifest: missing scenes table")
        scenes = data["scenes"]
        if not isinstance(scenes, dict):
            raise ManifestError("manifest.scenes: expected an object")
        for sid, rec in scenes.items():
            if not isinstance(rec, dict) or "versions" not in rec:
                raise ManifestError(f"scene {sid!r}: missing versions table")
            bad = set(rec) - {"active", "previous", "versions"}
            if bad:
                raise ManifestError(f"scene {sid!r}: unknown field(s) {sorted(bad)}")
            if not isinstance(rec["versions"], dict):
                raise ManifestError(
                    f"scene {sid!r}: versions must be an object, got "
                    f"{type(rec['versions']).__name__}"
                )
            for vstr, edata in rec["versions"].items():
                entry = entry_from_dict(edata, f"{sid} v{vstr}")
                if entry.scene_id != sid or str(entry.version) != vstr:
                    raise ManifestError(
                        f"entry keyed {sid!r}/v{vstr} declares "
                        f"{entry.scene_id!r}/v{entry.version}"
                    )
                m._entries[entry.key] = entry

            def pointer(name):
                """An int version pointer or None; anything else is
                malformed, not a crash (the strict ManifestError
                contract).  Strict: a bool/float pointer (JSON `true`,
                `1.7`) would otherwise round-trip by silent int()
                truncation."""
                val = rec.get(name)
                if val is None:
                    return None
                if isinstance(val, bool) or not isinstance(val, int):
                    raise ManifestError(
                        f"scene {sid!r}: {name} version {val!r} is not an "
                        "exact integer"
                    )
                return val

            active = pointer("active")
            if active is None or (sid, active) not in m._entries:
                raise ManifestError(
                    f"scene {sid!r}: active version {rec.get('active')!r} "
                    f"not in {sorted(v for s, v in m._entries if s == sid)}"
                )
            m._active[sid] = active
            previous = pointer("previous")
            if previous is not None:
                if (sid, previous) not in m._entries:
                    raise ManifestError(
                        f"scene {sid!r}: previous version "
                        f"{rec['previous']!r} has no entry"
                    )
                m._previous[sid] = previous
        return m

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SceneManifest":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ManifestError(f"manifest is not valid JSON: {e}") from e
        return cls.from_dict(data)

    def save(self, path: str | pathlib.Path) -> None:
        """Crash-atomic write (tmp + rename), same discipline as
        utils/checkpoint.py: a reader never sees a half-written manifest."""
        path = pathlib.Path(path)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "SceneManifest":
        try:
            text = pathlib.Path(path).read_text()
        except OSError as e:
            raise ManifestError(f"cannot read manifest {path}: {e}") from e
        return cls.from_json(text)
