"""The weight bridge: the JAX package's parameters, as nested dicts of numpy
arrays, into the port's modules.

Flax ``nn.Conv`` kernels are HWIO and become ``nn.Conv2d``'s OIHW; Flax
``nn.Dense`` kernels are (in, out) and become ``nn.Linear``'s (out, in).
Flax numbers ``Conv_k`` / ``Dense_k`` by call order, which is the order of
``ExpertNet.layers_in_flax_order`` (the conditional residual projection
included) and of ``GatingNet``'s and ``RetrieverNet``'s layers
(:func:`load_retriever`).  Nothing here imports flax or
orbax: the caller hands over the tree (``load_checkpoint`` output, or a
``load_scene_params`` tree converted to numpy).

:func:`load_reference_expert` / :func:`load_reference_gating` load the
original ESAC's ``torch.save(net.state_dict())`` files straight into the
port's modules (the counterpart of ``torch_state_dict_to_flax``): both
layouts are PyTorch's, so weights copy as they are, matched by layer order
(the reference nets are plain sequential stacks; names need not match).
:func:`reference_expert_state_dict` / :func:`reference_gating_state_dict`
are their inverses: a port model written as such a state dict, which
``torch.save`` stores for the original code and which the JAX package's
``torch_state_dict_to_flax`` reads back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet


def _params(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _numbered(p: dict, prefix: str) -> list[str]:
    names = [k for k in p if k.startswith(prefix)]
    return sorted(names, key=lambda k: int(k[len(prefix):]))


def _copy(dst: torch.Tensor, src: np.ndarray, where: str) -> None:
    src = np.array(src, dtype=np.float32)  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {src.shape} != module's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))


def _load_conv(conv: nn.Conv2d, leaf: dict, where: str) -> None:
    _copy(conv.weight, np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)), where)
    _copy(conv.bias, leaf["bias"], where)


def _load_dense(lin: nn.Linear, leaf: dict, where: str) -> None:
    _copy(lin.weight, np.transpose(np.asarray(leaf["kernel"])), where)
    _copy(lin.bias, leaf["bias"], where)


def load_expert(net: ExpertNet, tree: dict) -> ExpertNet:
    """Fill ``net`` from a Flax ``ExpertNet`` param tree (with or without
    the top-level ``params`` key).  Raises on a layer-count or shape
    mismatch, which catches a preset that does not fit the weights."""
    p = _params(tree)
    names = _numbered(p, "Conv_")
    convs = net.layers_in_flax_order()
    if len(names) != len(convs):
        raise ValueError(f"expert tree has {len(names)} convs, module {len(convs)}")
    for conv, name in zip(convs, names):
        _load_conv(conv, p[name], name)
    return net


def _load_convs_dense(net, tree: dict, what: str):
    """``Conv_k`` pairs into ``net.convs``, then ``Dense_0``, ``Dense_1``."""
    p = _params(tree)
    names = _numbered(p, "Conv_")
    if len(names) != len(net.convs) or _numbered(p, "Dense_") != ["Dense_0", "Dense_1"]:
        raise ValueError(f"{what} tree layers {sorted(p)} do not fit the module")
    for conv, name in zip(net.convs, names):
        _load_conv(conv, p[name], name)
    _load_dense(net.dense0, p["Dense_0"], "Dense_0")
    _load_dense(net.dense1, p["Dense_1"], "Dense_1")
    return net


def load_gating(net: GatingNet, tree: dict) -> GatingNet:
    """Fill ``net`` from a Flax ``GatingNet`` param tree."""
    return _load_convs_dense(net, tree, "gating")


def load_retriever(net, tree: dict):
    """Fill a ``retrieval.model.RetrieverNet`` from a Flax ``RetrieverNet``
    param tree (the gating net's layer order: ``Conv_k``, then ``Dense_0``,
    ``Dense_1``)."""
    return _load_convs_dense(net, tree, "retriever")


def _index(tree, m: int):
    if isinstance(tree, dict):
        return {k: _index(v, m) for k, v in tree.items()}
    return np.asarray(tree)[m]


def load_scene(scene: dict, tree: dict) -> dict:
    """Fill a scene's modules (``registry.serving.init_scene_params``
    output) from a ``load_scene_params``-shaped tree: ``expert`` stacked on
    a leading M axis, ``gating`` (gated presets), ``centers`` (M, 3), ``f``,
    ``c``.  Returns ``scene``."""
    experts = scene["expert"]
    for m, net in enumerate(experts):
        load_expert(net, _index(tree["expert"], m))
    if scene["gating"] is not None:
        load_gating(scene["gating"], tree["gating"])
    dev = scene["centers"].device
    for key in ("centers", "f", "c"):
        val = torch.as_tensor(np.asarray(tree[key], np.float32), device=dev)
        if val.shape != scene[key].shape:
            raise ValueError(f"{key}: shape {tuple(val.shape)} != {tuple(scene[key].shape)}")
        scene[key] = val
    return scene


def _state_dict_pairs(state_dict) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """(weight, bias or None) in order of appearance; raises on an entry
    that is neither, or a bias that does not follow its weight."""
    pairs: list[tuple[np.ndarray, np.ndarray | None]] = []
    pending_w, pending_name = None, ""
    for name, value in state_dict.items():
        arr = np.asarray(value.detach().cpu() if hasattr(value, "detach") else value)
        if name.endswith("weight"):
            if pending_w is not None:
                pairs.append((pending_w, None))
            pending_w, pending_name = arr, name
        elif name.endswith("bias"):
            if pending_w is None or name[: -len("bias")] != pending_name[: -len("weight")]:
                raise ValueError(f"bias {name} does not follow its weight")
            pairs.append((pending_w, arr))
            pending_w = None
        else:
            raise ValueError(f"unsupported torch entry: {name}")
    if pending_w is not None:
        pairs.append((pending_w, None))
    return pairs


def _load_in_order(layers: list[nn.Module], state_dict) -> None:
    pairs = _state_dict_pairs(state_dict)
    if len(pairs) != len(layers):
        raise ValueError(f"layer count mismatch: torch has {len(pairs)}, "
                         f"module has {len(layers)}")
    for k, (layer, (w, b)) in enumerate(zip(layers, pairs)):
        _copy(layer.weight, w, f"layer {k}")
        if b is not None:
            _copy(layer.bias, b, f"layer {k} bias")


def load_reference_expert(net: ExpertNet, state_dict) -> ExpertNet:
    """Fill ``net`` from an original-ESAC expert state dict, layer k onto
    ``net.layers_in_flax_order()[k]``.  Raises ValueError on a layer-count
    or shape mismatch (architecture drift)."""
    _load_in_order(net.layers_in_flax_order(), state_dict)
    return net


def load_reference_gating(net: GatingNet, state_dict) -> GatingNet:
    """Fill ``net`` from an original-ESAC gating state dict: its convs,
    then the two dense layers."""
    _load_in_order(list(net.convs) + [net.dense0, net.dense1], state_dict)
    return net


def _state_dict_in_order(layers: list[nn.Module]) -> dict[str, torch.Tensor]:
    """``layer{k}.weight`` / ``layer{k}.bias`` of each layer in order:
    detached float32 CPU copies."""
    sd = {}
    for k, layer in enumerate(layers):
        sd[f"layer{k}.weight"] = layer.weight.detach().float().cpu().clone()
        if layer.bias is not None:
            sd[f"layer{k}.bias"] = layer.bias.detach().float().cpu().clone()
    return sd


def reference_expert_state_dict(net: ExpertNet) -> dict[str, torch.Tensor]:
    """``net`` as an original-ESAC expert state dict, layer k from
    ``net.layers_in_flax_order()[k]`` (the inverse of
    :func:`load_reference_expert`; the scene center is not a layer and is
    not written)."""
    return _state_dict_in_order(net.layers_in_flax_order())


def reference_gating_state_dict(net: GatingNet) -> dict[str, torch.Tensor]:
    """``net`` as an original-ESAC gating state dict: its convs, then the
    two dense layers (the inverse of :func:`load_reference_gating`)."""
    return _state_dict_in_order(list(net.convs) + [net.dense0, net.dense1])
