"""The port's ExpertNet / GatingNet against the Flax nets, through the
weight bridge (esac_tpu_torch.models.convert).

Parameters come from the JAX package's own init (or the committed
checkpoint), pass through the bridge, and both nets see the same seeded
image in float32.  Tolerance: rtol 1e-4, atol 1e-4 -- float32 convolutions
by different libraries (XLA vs oneDNN) accumulate in different orders over
up to 3x3x512 products per output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esac_tpu.models import ExpertNet as JExpertNet
from esac_tpu.models import GatingNet as JGatingNet
from esac_tpu.utils.checkpoint import load_checkpoint
from esac_tpu.models.convert import torch_state_dict_to_flax
from esac_tpu_torch.models.convert import (
    load_expert, load_gating, load_reference_expert, load_reference_gating,
    reference_expert_state_dict, reference_gating_state_dict,
)
from esac_tpu_torch.models.expert import ExpertNet
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS

TOL = dict(rtol=1e-4, atol=1e-4)
REF_NARROW_DEPTH = dict(EXPERT_PRESETS["ref"], head_depth=1)  # full widths, 1 block


def _image(seed, h, w, batch=2):
    return np.random.default_rng(seed).uniform(0, 1, (batch, h, w, 3)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", [EXPERT_PRESETS["test"], REF_NARROW_DEPTH],
                         ids=["test", "ref_widths_depth1"])
def test_expert_matches_flax(arch):
    """The ref widths change channels at head block 0 (256 -> 512), so the
    conditional projection conv -- and Flax's call-order Conv_k numbering
    around it -- is exercised; the test preset has none."""
    center = (1.0, -2.0, 0.5)
    jnet = JExpertNet(scene_center=center, compute_dtype=jnp.float32, **arch)
    img = _image(0, 16, 24)
    params = jnet.init(jax.random.key(0), img)
    want = np.asarray(jnet.apply(params, img))
    net = load_expert(ExpertNet(center, compute_dtype=torch.float32, **arch),
                      _np_tree(params))
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 2, 3, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("preset", ["test", "ref"])
def test_gating_matches_flax(preset):
    chans = GATING_PRESETS[preset]["channels"]
    jnet = JGatingNet(num_experts=7, channels=chans, compute_dtype=jnp.float32)
    img = _image(1, 16, 24)
    params = jnet.init(jax.random.key(1), img)
    want = np.asarray(jnet.apply(params, img))
    net = load_gating(GatingNet(7, chans, compute_dtype=torch.float32), _np_tree(params))
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, **TOL)


def test_committed_checkpoint_through_the_bridge():
    """ckpts/ckpt_expert_synth0 (a trained test-size expert), read with the
    JAX package's loader: the port reproduces its coordinate map."""
    params, cfg = load_checkpoint("ckpts/ckpt_expert_synth0")
    center = tuple(cfg["scene_center"])
    jnet = JExpertNet(scene_center=center, compute_dtype=jnp.float32,
                      **EXPERT_PRESETS[cfg["size"]])
    img = _image(2, 96, 128, batch=1)
    want = np.asarray(jnet.apply(params, img))
    net = load_expert(ExpertNet(center, compute_dtype=torch.float32,
                                **EXPERT_PRESETS[cfg["size"]]), params)
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bridge_rejects_a_preset_that_does_not_fit():
    params = JExpertNet(compute_dtype=jnp.float32, **EXPERT_PRESETS["test"]).init(
        jax.random.key(0), _image(0, 16, 16, batch=1))
    with pytest.raises(ValueError):
        load_expert(ExpertNet(**EXPERT_PRESETS["small"]), _np_tree(params))


@pytest.mark.parametrize("kind,preset", [("expert", "test"), ("expert", "ref_depth1"),
                                         ("gating", "test")])
def test_reference_state_dict_round_trips_to_the_flax_tree(kind, preset):
    """A Flax tree -> the port's module (load_expert / load_gating) -> an
    original-ESAC state dict (reference_*_state_dict) -> the JAX package's
    torch_state_dict_to_flax: the same tree, bit for bit; and the state
    dict loads back into a fresh module with load_reference_*."""
    img = _image(4, 16, 24, batch=1)
    if kind == "expert":
        arch = EXPERT_PRESETS["test"] if preset == "test" else REF_NARROW_DEPTH
        params = JExpertNet(compute_dtype=jnp.float32, **arch).init(jax.random.key(4), img)
        make = lambda: ExpertNet(compute_dtype=torch.float32, **arch)  # noqa: E731
        net = load_expert(make(), _np_tree(params))
        sd, load_ref = reference_expert_state_dict(net), load_reference_expert
    else:
        chans = GATING_PRESETS["test"]["channels"]
        params = JGatingNet(num_experts=5, channels=chans, compute_dtype=jnp.float32).init(
            jax.random.key(4), img)
        make = lambda: GatingNet(5, chans, compute_dtype=torch.float32)  # noqa: E731
        net = load_gating(make(), _np_tree(params))
        sd, load_ref = reference_gating_state_dict(net), load_reference_gating
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in sd.values())
    back = torch_state_dict_to_flax(sd, params["params"])
    want = jax.tree.leaves_with_path(params["params"])
    got = jax.tree.leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    again = load_ref(make(), sd)
    for (name, a), (_, b) in zip(again.state_dict().items(), net.state_dict().items()):
        assert torch.equal(a, b), name
