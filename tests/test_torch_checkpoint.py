"""The port's checkpoints (esac_tpu_torch.utils.checkpoint), profiling
helpers, and the two weight bridges into its modules: the JAX package's
Orbax checkpoints (read on the test side only) and the original ESAC's
torch state dicts.

Tolerance of the carried-across expert: tests/test_torch_models.py's rtol /
atol 1e-4 (float32 convolutions of two libraries).  Everything else is
held bit for bit.
"""

import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.models.convert import torch_state_dict_to_flax
from esac_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from esac_tpu_torch.models.convert import (
    load_expert,
    load_gating,
    load_reference_expert,
    load_reference_gating,
)
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.scripts import convert_checkpoint
from esac_tpu_torch.utils.checkpoint import (
    checkpoint_nbytes,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from esac_tpu_torch.utils.profiling import StageTimer, hypotheses_per_sec, wait_for

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_models.py


def _tiny_net(seed=0):
    torch.manual_seed(seed)
    return ExpertNet(stem_channels=(4, 8, 8), head_channels=8, head_depth=1,
                     compute_dtype=torch.float32)


def _trained(steps=3, seed=0):
    net = _tiny_net(seed)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    x = torch.as_tensor(np.random.default_rng(seed).uniform(0, 1, (2, 16, 16, 3)),
                        dtype=torch.float32)
    for _ in range(steps):
        opt.zero_grad()
        net(x).square().mean().backward()
        opt.step()
    return net, opt, x


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    return a == b


def test_save_load_round_trip_and_overwrite(tmp_path):
    net = _tiny_net(0)
    params = {"expert": net.state_dict(), "gating": GatingNet(3, (4, 8)).state_dict()}
    save_checkpoint(tmp_path / "ck", params, {"kind": "expert", "size": "test"})
    got, cfg = load_checkpoint(tmp_path / "ck")
    assert _equal_trees(got, params) and cfg == {"kind": "expert", "size": "test"}
    assert all(t.device.type == "cpu" for t in got["expert"].values())
    other = _tiny_net(1).state_dict()
    save_checkpoint(tmp_path / "ck", other, {"kind": "expert", "size": "ref"})
    got, cfg = load_checkpoint(tmp_path / "ck", map_location="cpu")
    assert _equal_trees(got, other) and cfg["size"] == "ref"
    assert checkpoint_nbytes(tmp_path / "ck") == sum(
        t.numel() * t.element_size() for t in other.values())


def test_train_state_restores_adam_bit_for_bit(tmp_path):
    net, opt, x = _trained()
    save_train_state(tmp_path / "ck", net.state_dict(), {"kind": "expert"}, opt.state_dict(), 3)
    params, opt_state, cfg, it = load_train_state(tmp_path / "ck")
    assert it == 3 and cfg == {"kind": "expert", "iteration": 3}
    net2 = _tiny_net(5)
    opt2 = torch.optim.Adam(net2.parameters(), lr=1e-2)
    net2.load_state_dict(params)
    opt2.load_state_dict(opt_state)
    assert _equal_trees(opt2.state_dict(), opt.state_dict())
    for p in net.parameters():
        assert float(opt.state[p]["step"]) == 3.0
    for model, o in ((net, opt), (net2, opt2)):  # one more step each: still equal
        o.zero_grad()
        model(x).square().mean().backward()
        o.step()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
    save_checkpoint(tmp_path / "plain", net.state_dict(), {})
    with pytest.raises(FileNotFoundError, match="not a resume-capable"):
        load_train_state(tmp_path / "plain")


@pytest.mark.parametrize("crash", ["between_renames", "staging_left_behind"])
def test_train_state_is_crash_atomic(tmp_path, crash):
    """Mirrors tests/test_checkpoint.py: a death between the two renames
    leaves <path>.old, which readers fall back to and the next save repairs
    before deleting anything; a death mid-write leaves <path>.staging, which
    readers ignore and the next save replaces."""
    net, opt, _ = _trained()
    ck = tmp_path / "ck"
    save_train_state(ck, net.state_dict(), {"k": 1}, opt.state_dict(), 3)
    if crash == "between_renames":
        ck.rename(tmp_path / "ck.old")
        with pytest.warns(UserWarning, match="ck.old"):
            _, _, cfg, it = load_train_state(ck)
        assert it == 3 and cfg["k"] == 1
        with pytest.warns(UserWarning, match="ck.old"):
            assert load_checkpoint(ck)[1]["k"] == 1
    else:
        staging = tmp_path / "ck.staging"
        staging.mkdir()
        (staging / "params.pt").write_bytes(b"half a file")
        _, _, cfg, it = load_train_state(ck)
        assert it == 3 and cfg["k"] == 1
    save_train_state(ck, net.state_dict(), {"k": 2}, opt.state_dict(), 4)
    assert not (tmp_path / "ck.old").exists() and not (tmp_path / "ck.staging").exists()
    params, _, cfg, it = load_train_state(ck)
    assert it == 4 and cfg["k"] == 2 and _equal_trees(params, net.state_dict())


def test_stage_timer_counts_and_totals():
    t = StageTimer()
    for _ in range(3):
        with t("a"):
            time.sleep(0.01)
    with t("b", fence=torch.device("cpu")) as holder:
        holder.append(torch.zeros(2))
    assert t.counts == {"a": 3, "b": 1}
    assert 0.03 <= t.totals["a"] < 1.0 and len(t.calls["a"]) == 3
    assert abs(sum(t.calls["a"]) - t.totals["a"]) < 1e-12
    lines = t.summary().splitlines()
    assert lines[0].startswith("a") and "x3" in lines[0] and "x1" in lines[1]
    wait_for(None)
    wait_for(torch.zeros(1))
    assert hypotheses_per_sec(lambda x: x + 1, (torch.zeros(4),), 256, repeats=3) > 0


def test_jax_checkpoint_carried_across(tmp_path):
    """ckpts/ckpt_expert_synth0 (Orbax, read by the JAX package) -> the
    bridge -> a port checkpoint -> reloaded: the port's ExpertNet agrees
    with the JAX ExpertNet on the same image."""
    tree, cfg = j_load_checkpoint(ROOT / "ckpts" / "ckpt_expert_synth0")
    arch = EXPERT_PRESETS[cfg["size"]]
    net = load_expert(ExpertNet(scene_center=cfg["scene_center"], compute_dtype=torch.float32,
                                **arch), jax.tree.map(np.asarray, tree))
    save_checkpoint(tmp_path / "ck", net.state_dict(), cfg)
    params, cfg2 = load_checkpoint(tmp_path / "ck")
    assert cfg2 == cfg
    back = ExpertNet(compute_dtype=torch.float32, **arch)
    back.load_state_dict(params)
    img = np.random.default_rng(0).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    jnet = JExpertNet(scene_center=tuple(cfg["scene_center"]), compute_dtype=jnp.float32,
                      **arch)
    want = np.asarray(jnet.apply(tree, jnp.asarray(img)))
    with torch.no_grad():
        got = back(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _reference_state_dict(layers, rng, names):
    """A random state dict in the original ESAC's layout (PyTorch's OIHW /
    (out, in)), one (weight, bias) per layer, in layer order."""
    sd = {}
    for name, layer in zip(names, layers):
        sd[f"{name}.weight"] = torch.as_tensor(
            rng.normal(size=tuple(layer.weight.shape)), dtype=torch.float32)
        sd[f"{name}.bias"] = torch.as_tensor(rng.normal(size=tuple(layer.bias.shape)),
                                             dtype=torch.float32)
    return sd


def _call_order(params):
    """Flax ``init`` returns the layers in call order (``Conv_k`` by k, then
    ``Dense_k``), which ``torch_state_dict_to_flax`` walks; ``eval_shape``
    (shapes without compiling the init) returns them sorted by name."""
    def key(name):
        kind, k = name.rsplit("_", 1)
        return kind != "Conv", int(k)

    return {name: params[name] for name in sorted(params, key=key)}


@pytest.mark.parametrize("kind", ["expert", "gating"])
def test_reference_state_dict_loader_matches_jax_path(kind):
    """A reference-layout state dict through JAX's torch_state_dict_to_flax
    (on the Flax module's parameter shapes) and the Flax bridge, and through
    the port's own loader: equal parameters."""
    rng = np.random.default_rng(3)
    probe = jnp.zeros((1, 32, 32, 3))
    if kind == "expert":
        make = lambda: ExpertNet(compute_dtype=torch.float32, **EXPERT_PRESETS["test"])  # noqa: E731
        layers = make().layers_in_flax_order()
        jparams = jax.eval_shape(JExpertNet(**EXPERT_PRESETS["test"]).init,
                                 jax.random.key(0), probe)
        bridge, ours = load_expert, load_reference_expert
    else:
        make = lambda: GatingNet(3, GATING_PRESETS["test"]["channels"])  # noqa: E731
        net = make()
        layers = list(net.convs) + [net.dense0, net.dense1]
        jparams = jax.eval_shape(JGatingNet(num_experts=3, **GATING_PRESETS["test"]).init,
                                 jax.random.key(0), probe)
        bridge, ours = load_gating, load_reference_gating
    sd = _reference_state_dict(layers, rng, [f"net.{k}" for k in range(len(layers))])
    tree = torch_state_dict_to_flax(sd, _call_order(jparams["params"]))
    a = bridge(make(), {"params": jax.tree.map(np.asarray, tree)})
    b = ours(make(), sd)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    with pytest.raises(ValueError, match="shape"):
        bad = dict(sd)
        key = next(iter(bad))
        bad[key] = bad[key][:, :-1]
        ours(make(), bad)
    with pytest.raises(ValueError, match="layer count"):
        ours(make(), dict(list(sd.items())[:-2]))
    with pytest.raises(ValueError, match="does not follow"):
        ours(make(), {"x.bias": torch.zeros(1)})


def test_convert_checkpoint_script(tmp_path):
    rng = np.random.default_rng(4)
    layers = ExpertNet(**EXPERT_PRESETS["test"]).layers_in_flax_order()
    sd = _reference_state_dict(layers, rng, [f"conv{k}" for k in range(len(layers))])
    torch.save(sd, tmp_path / "ref.pth")
    assert convert_checkpoint.main(["expert", str(tmp_path / "ref.pth"), str(tmp_path / "ck"),
                                    "--size", "test", "--scene-center", "1", "2", "3"]) == 0
    params, cfg = load_checkpoint(tmp_path / "ck")
    assert cfg["kind"] == "expert" and cfg["scene_center"] == [1.0, 2.0, 3.0]
    assert torch.equal(params["scene_center"], torch.tensor([1.0, 2.0, 3.0]))
    net = ExpertNet(**EXPERT_PRESETS["test"])
    net.load_state_dict(params)
    for layer, (w, b) in zip(net.layers_in_flax_order(), zip(*[iter(sd.values())] * 2)):
        assert torch.equal(layer.weight, w) and torch.equal(layer.bias, b)
    assert json.loads((tmp_path / "ck" / "config.json").read_text())["size"] == "test"
