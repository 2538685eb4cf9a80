"""The CNNs' convolution epilogue (``models.expert.conv_epilogue``): which
path a call takes, the separate-op path bit-identical to the forms the nets
had before it, the fused path's arithmetic (its cuDNN ops replaced by
plain float32 stand-ins, so the CPU runs it), the convolution counts of a
traced call, and back-propagation with autograd on.

The cases marked ``card`` need a CUDA card and skip without one.  This file
imports no JAX, so on the card it runs without the test directory's
conftest:

    python -m pytest --noconftest tests/test_torch_conv_epilogue.py -m card
"""

import time
import types

import pytest
import torch
import torch.nn.functional as F

from esac_tpu_torch.models import expert as expert_mod
from esac_tpu_torch.models.expert import ExpertNet, conv_in_dtype, fuses
from esac_tpu_torch.models.gating import GatingNet
from esac_tpu_torch.models.presets import EXPERT_PRESETS, GATING_PRESETS
from esac_tpu_torch.obs.trace import CONV_COUNTS, StageClock, stage_scope

H, W = 32, 48


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with "
                    "python -m pytest --noconftest tests/test_torch_conv_epilogue.py -m card")
    return torch.device("cuda", 0)


def _nets(preset, dtype, device="cpu", seed=0):
    torch.manual_seed(seed)
    expert = ExpertNet((0.5, -1.0, 2.0), compute_dtype=dtype, **EXPERT_PRESETS[preset])
    gating = GatingNet(7, channels=GATING_PRESETS[preset]["channels"], compute_dtype=dtype)
    return expert.to(device).eval(), gating.to(device).eval()


def _image(batch=2, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((batch, H, W, 3), generator=g).to(device)


def _expert_before(net, x):
    """ExpertNet.forward as it was written before conv_epilogue."""
    lead = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(net.compute_dtype)
    for conv in net.stem:
        x = F.relu(conv_in_dtype(conv, x))
    for block in net.head:
        h = F.relu(conv_in_dtype(block["conv3"], x))
        h = conv_in_dtype(block["conv1"], h)
        if "proj" in block:
            x = conv_in_dtype(block["proj"], x)
        x = F.relu(x + h)
    x = net.coord(x.float())
    x = x.permute(0, 2, 3, 1) + net.scene_center
    return x.reshape(lead + x.shape[1:])


def _gating_before(net, x):
    """GatingNet.forward as it was written before conv_epilogue."""
    lead = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(net.compute_dtype)
    for conv in net.convs:
        x = F.relu(conv_in_dtype(conv, x))
    x = x.mean(dim=(2, 3)).float()
    x = net.dense1(F.relu(net.dense0(x)))
    return x.reshape(lead + x.shape[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("is_cuda", [True, False])
def test_the_path_follows_device_grad_mode_and_dtype(is_cuda, grad, dtype):
    x = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)
    with torch.set_grad_enabled(grad):
        got = fuses(x)
    assert got == (is_cuda and not grad and dtype != torch.float32)


@pytest.mark.parametrize("mode", ["inference", "grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("preset", ["test", "small"])
def test_cpu_forwards_are_bit_identical_to_the_forms_before(preset, dtype, mode):
    expert, gating = _nets(preset, dtype)
    x = _image()
    ctx = torch.inference_mode() if mode == "inference" else torch.enable_grad()
    with ctx:
        pairs = [(expert(x), _expert_before(expert, x)), (gating(x), _gating_before(gating, x))]
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _cudnn_relu(x, w, b, stride, padding, dilation, groups):
    """Stand-in for ``torch.cudnn_convolution_relu``: the epilogue in
    float32, rounded once."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride, padding, dilation, groups)
    return F.relu(y).to(x.dtype)


def _cudnn_add_relu(x, w, z, alpha, b, stride, padding, dilation, groups):
    """Stand-in for ``torch.cudnn_convolution_add_relu``."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride, padding, dilation, groups)
    return F.relu(y + alpha * z.float()).to(x.dtype)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The fused path on the CPU: fuses()'s rule as on the card, but for
    float32 too (so that the fused arithmetic can be held to float32
    rounding), the cuDNN ops replaced by their stand-ins; counts each
    stand-in's calls."""
    calls = {"relu": 0, "add_relu": 0}

    def relu(*args):
        calls["relu"] += 1
        return _cudnn_relu(*args)

    def add_relu(*args):
        calls["add_relu"] += 1
        return _cudnn_add_relu(*args)

    rule = fuses
    half = {torch.float32: torch.bfloat16}
    monkeypatch.setattr(expert_mod, "fuses", lambda x: rule(
        types.SimpleNamespace(is_cuda=True, dtype=half.get(x.dtype, x.dtype))))
    monkeypatch.setattr(torch, "cudnn_convolution_relu", relu)
    monkeypatch.setattr(torch, "cudnn_convolution_add_relu", add_relu)
    return calls


@pytest.mark.parametrize("cin", [3, 8, 64])
def test_every_channel_count_fuses(fused_on_cpu, cin):
    """No channel rule: cuDNN pads a 3-channel input as it does for the
    separate convolution."""
    torch.manual_seed(cin)
    conv = torch.nn.Conv2d(cin, 16, 3, padding=1)
    x = torch.rand((2, cin, 8, 8)).to(torch.bfloat16)
    with torch.inference_mode():
        got = expert_mod.conv_epilogue(conv, x)
    assert fused_on_cpu == {"relu": 1, "add_relu": 0}
    want = F.relu(conv_in_dtype(conv, x))
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -7)


def _biased(net, seed=5):
    """Every convolution bias non-zero, so that a bias dropped or added
    twice shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return net


@pytest.mark.parametrize("preset", ["test", "small"])
def test_the_fused_arithmetic_and_the_projection_bias_fold(fused_on_cpu, preset):
    """In float32 the fused path (bias, residual and ReLU in one epilogue;
    head block 0's projection without its bias, which joins the 1x1
    convolution's) agrees with the separate ops within float32 rounding."""
    expert, gating = _nets(preset, torch.float32, seed=3)
    _biased(expert), _biased(gating)
    x = _image()
    with torch.inference_mode():
        got = (expert(x), gating(x))
    with torch.enable_grad():
        want = (expert(x), gating(x))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())
    depth = EXPERT_PRESETS[preset]["head_depth"]
    # every 3x3 convolution of the expert and the gating; each head
    # block's 1x1 adds the residual
    assert fused_on_cpu == {"relu": 7 + depth + 2 * len(GATING_PRESETS[preset]["channels"]),
                            "add_relu": depth}


def test_a_dropped_projection_bias_would_show(fused_on_cpu):
    """The fold carries head block 0's projection bias: dropping it moves
    the output (the small preset has a projection)."""
    expert, _ = _nets("small", torch.float32, seed=3)
    _biased(expert)
    x = _image()
    with torch.inference_mode():
        got = expert(x)
        expert.head[0]["proj"].bias.zero_()
        dropped = expert(x)
    assert (got - dropped).abs().max() > 1e-3


@pytest.mark.parametrize("preset", ["test", "small"])
def test_the_fused_path_in_bf16_rounds_no_farther_from_float32(fused_on_cpu, preset):
    """One rounding a convolution instead of two or three: the fused bf16
    forward lies no farther from the float32 forward than the separate one
    (with some room: both are bf16)."""
    expert, _ = _nets(preset, torch.bfloat16, seed=4)
    _biased(expert)
    x = _image()
    with torch.inference_mode():
        fused = expert(x)
    with torch.enable_grad():
        separate = expert(x)
        expert.compute_dtype = torch.float32
        exact = expert(x)
    err_fused = (fused - exact).abs().mean().item()
    err_separate = (separate - exact).abs().mean().item()
    assert err_fused <= 1.25 * err_separate


def _counted(fn):
    clock = StageClock(time.perf_counter, torch.device("cpu"))
    with stage_scope(clock):
        out = fn()
    return out, dict(clock.conv_stages())


@pytest.mark.parametrize("preset", ["test", "small"])
def test_a_traced_call_counts_every_convolution(fused_on_cpu, preset):
    expert, gating = _nets(preset, torch.bfloat16)
    x = _image()
    n = len(expert.layers_in_flax_order()) + len(gating.convs)
    with torch.enable_grad():
        _, separate = _counted(lambda: (expert(x), gating(x)))
    with torch.inference_mode():
        _, fused = _counted(lambda: (expert(x), gating(x)))
    assert separate == {"cnn.convs": n, "cnn.fused_convs": 0}
    # all but the coordinate head
    assert fused == {"cnn.convs": n, "cnn.fused_convs": n - 1}
    assert set(fused) == set(CONV_COUNTS)


def test_an_untraced_call_counts_nothing_and_a_clock_without_convs_is_empty():
    clock = StageClock(time.perf_counter, torch.device("cpu"))
    expert, _ = _nets("test", torch.float32)
    with torch.inference_mode():
        expert(_image())
    assert clock.conv_stages() == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_grad_enabled_forward_back_propagates(fused_on_cpu, dtype):
    """Autograd on keeps the separate ops (the fused ones have no backward):
    every convolution gets a finite, non-zero gradient."""
    expert, gating = _nets("test", dtype)
    x = _image()
    loss = expert(x).square().mean() + gating(x).square().mean()
    loss.backward()
    assert fused_on_cpu == {"relu": 0, "add_relu": 0}
    for net in (expert, gating):
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                assert torch.isfinite(m.weight.grad).all() and m.weight.grad.abs().sum() > 0


# ----------------------------------------------------------------- card


@pytest.mark.card
def test_card_fused_ref_forward_rounds_no_farther_from_float32(card):
    """At the ref widths on the card, in bf16: the fused forward against
    the separate one and a float32 one (TF32 off)."""
    expert, gating = _nets("ref", torch.bfloat16, device=card)
    _biased(expert), _biased(gating)
    x = _image(batch=4, device=card)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            fused = (expert(x), gating(x))
        with torch.enable_grad():
            separate = (expert(x), gating(x))
            expert.compute_dtype = gating.compute_dtype = torch.float32
            exact = (expert(x), gating(x))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for f, s, e in zip(fused, separate, exact):
        assert torch.isfinite(f).all()
        assert (f - e).abs().mean().item() <= 1.25 * (s - e).abs().mean().item()


@pytest.mark.card
def test_card_fused_count_equals_the_fused_calls(card, monkeypatch):
    """``cnn.fused_convs`` of a traced call equals the cuDNN fused calls it
    made plus the projection folded into one of them."""
    calls = {"n": 0}
    for name in ("cudnn_convolution_relu", "cudnn_convolution_add_relu"):
        op = getattr(torch, name)

        def wrapped(*args, op=op):
            calls["n"] += 1
            return op(*args)

        monkeypatch.setattr(torch, name, wrapped)
    expert, gating = _nets("ref", torch.bfloat16, device=card)
    x = _image(batch=2, device=card)
    with torch.inference_mode():
        _, counts = _counted(lambda: (expert(x), gating(x)))
    projs = sum("proj" in block for block in expert.head)
    assert counts["cnn.fused_convs"] == calls["n"] + projs
    assert counts["cnn.convs"] == len(expert.layers_in_flax_order()) + len(gating.convs)
    assert counts["cnn.fused_convs"] == counts["cnn.convs"] - 1
