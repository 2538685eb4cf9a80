"""Checkpoint save / restore in torch format (counterpart of
``esac_tpu/utils/checkpoint.py``).  A checkpoint is a directory:

    <path>/params.pt     the nets' state_dicts (a state_dict, or a dict of them)
    <path>/opt_state.pt  train states only: the optimizer's state_dict
    <path>/config.json   net architecture + scene metadata, the keys the JAX
                         package's scripts write; a train state adds
                         "iteration"

Tensors are saved from host memory and loaded with ``weights_only=True``
and an explicit ``map_location``, so a checkpoint written on the card
loads anywhere.  The JAX package's Orbax checkpoints are not read here:
``models.convert.load_expert`` / ``load_gating`` carry their numpy trees
into the port's modules, whose state_dicts this module then saves.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import warnings
from typing import Any

import torch

PARAMS = "params.pt"
OPT_STATE = "opt_state.pt"
CONFIG = "config.json"


def _to_host(tree: Any) -> Any:
    """Every tensor of a nested dict / list state moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _load(path: pathlib.Path, map_location, mmap: bool = False) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True, mmap=mmap)


def save_checkpoint(path: str | pathlib.Path, params: Any, config: dict) -> None:
    """Write ``params`` (a state_dict or a dict of them) and ``config``."""
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_to_host(params), path / PARAMS)
    (path / CONFIG).write_text(json.dumps(config, indent=2))


def save_train_state(path: str | pathlib.Path, params: Any, config: dict,
                     opt_state: dict, iteration: int) -> None:
    """Resume-capable checkpoint: params + the optimizer's state_dict +
    ``config["iteration"]``; eval scripts keep reading params / config.

    Crash-atomic: the whole state is written into a ``.staging`` sibling
    and swapped in by two renames, so a process that dies mid-save never
    leaves a half-written checkpoint at ``path``.  Between the renames the
    previous state survives at ``<path>.old``, which every reader falls
    back to and the next save repairs first.
    """
    path = pathlib.Path(path).absolute()
    old = path.with_name(path.name + ".old")
    if not path.exists() and old.exists():
        # Repair a crash between the renames BEFORE deleting anything:
        # .old is then the only surviving state.
        os.rename(old, path)
    staging = path.with_name(path.name + ".staging")
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    torch.save(_to_host(params), staging / PARAMS)
    torch.save(_to_host(opt_state), staging / OPT_STATE)
    (staging / CONFIG).write_text(json.dumps({**config, "iteration": int(iteration)}, indent=2))
    if old.exists():
        shutil.rmtree(old)  # safe: a complete checkpoint exists at path
    if path.exists():
        os.rename(path, old)
    os.rename(staging, path)
    shutil.rmtree(old, ignore_errors=True)


def _with_old_fallback(path: str | pathlib.Path) -> pathlib.Path:
    """A death between save_train_state's two renames leaves the previous
    state at <path>.old; every reader falls back to it."""
    path = pathlib.Path(path).absolute()
    old = path.with_name(path.name + ".old")
    if not path.exists() and old.exists():
        warnings.warn(f"{path} missing; reading {old.name} (crash between "
                      "checkpoint renames)")
        return old
    return path


def load_checkpoint(path: str | pathlib.Path, map_location="cpu") -> tuple[Any, dict]:
    """Restore (params, config), the tensors on ``map_location``."""
    path = _with_old_fallback(path)
    params = _load(path / PARAMS, map_location)
    return params, json.loads((path / CONFIG).read_text())


def load_train_state(path: str | pathlib.Path, map_location="cpu"
                     ) -> tuple[Any, dict, dict, int]:
    """Restore (params, opt_state, config, iteration).  ``opt_state`` is a
    state_dict for ``optimizer.load_state_dict``, which checks it against
    the optimizer's parameter groups.  Raises FileNotFoundError for a
    checkpoint without optimizer state (written by :func:`save_checkpoint`)."""
    path = _with_old_fallback(path)
    opt_file = path / OPT_STATE
    if not opt_file.exists():
        raise FileNotFoundError(f"{opt_file} (not a resume-capable checkpoint)")
    params, config = load_checkpoint(path, map_location)
    opt_state = _load(opt_file, map_location)
    return params, opt_state, config, int(config.get("iteration", 0))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def checkpoint_nbytes(path: str | pathlib.Path) -> int:
    """Total bytes of every tensor in ``<path>/params.pt`` (buffers such as
    an expert's scene center included), read from a memory map: no tensor
    data is read.  Sizes a device weight cache ahead of any load."""
    path = _with_old_fallback(path)
    params = _load(path / PARAMS, "cpu", mmap=True)
    return sum(t.numel() * t.element_size() for t in _tensors(params))
