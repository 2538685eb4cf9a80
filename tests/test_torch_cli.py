"""The port's entry scripts (esac_tpu_torch/scripts) in process, on the CPU
at the test size (--cpu --size test, 96x128, 4 frames a scene): the
three-stage workflow and its evaluation, exact resume, the learning-rate
schedule against optax's, and the flag surface against the JAX package's
scripts (read on the test side only).

Resume is held bit for bit (torch.equal on every parameter and optimizer
tensor); the schedule within rtol 1e-6 (optax evaluates it in float32).
"""

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import optax
import pytest
import torch

from esac_tpu_torch import cli
from esac_tpu_torch.scripts import test_esac, train_esac, train_expert, train_gating
from esac_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state, save_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMON = ["--cpu", "--size", "test", "--batch", "2", "--frames", "4", "--learningrate", "1e-3"]
PORT = {"train_expert": train_expert, "train_gating": train_gating, "train_esac": train_esac,
        "test_esac": test_esac}
# Flags of the JAX scripts this slice has no counterpart for.
ABSENT = {"backend", "sharded", "capacity", "devices"}


def run(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Stage 1 for synth0 and synth1, stage 2, stage 3 under "pallas" (the
    plain version on the CPU), then evaluation dense and with --topk 1."""
    d = tmp_path_factory.mktemp("workflow")
    out = {"dir": d}
    for i in range(2):
        out[f"e{i}"] = run(train_expert, [f"synth{i}", *COMMON, "--iterations", "4",
                                          "--output", str(d / f"e{i}")])
    out["g"] = run(train_gating, ["synth0", "synth1", *COMMON, "--iterations", "4",
                                  "--output", str(d / "g")])
    ckpts = ["--experts", str(d / "e0"), str(d / "e1"), "--gating", str(d / "g")]
    out["ckpts"] = ckpts
    out["esac"] = run(train_esac, ["synth0", "synth1", *COMMON, "--iterations", "4",
                                   "--hypotheses", "16", "--scoring-impl", "pallas", *ckpts,
                                   "--output", str(d / "esac")])
    e2e = ["--experts", str(d / "esac_expert0"), str(d / "esac_expert1"),
           "--gating", str(d / "esac_gating")]
    for name, extra in (("dense", []), ("topk", ["--topk", "1"])):
        out[name] = run(test_esac, ["synth0", "synth1", "--cpu", "--size", "test", "--frames",
                                    "4", "--hypotheses", "16", "--limit", "3", "--eval-batch",
                                    "4", "--scoring-impl", "pallas", *e2e, *extra,
                                    "--json", str(d / f"{name}.json")])
    return out


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _print_prefixes(path):
    """The constant head of every print() in a script's source."""
    heads = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                first = arg.values[0]
                heads.add(first.value if isinstance(first, ast.Constant) else "")
            elif isinstance(arg, ast.Constant):
                heads.add(arg.value)
    return heads


def _json_dump_keys(path):
    """Keys of the dict literal the JAX evaluation script dumps, and of its
    "per_frame" record (its ``**`` extras belong to --sharded)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dump":
            record = node.args[0]
            keys = [k.value for k in record.keys if k is not None]
            per_frame = record.values[keys.index("per_frame")]
            return keys, [k.value for k in per_frame.keys]
    raise AssertionError("no json.dump in the JAX script")


@pytest.mark.parametrize("name", sorted(PORT))
def test_scripts_print_the_jax_scripts_lines(name):
    """The trainers print their loop's lines through cli.train_loop and
    cli.resume_train_state."""
    jax_heads = _print_prefixes(ROOT / f"{name}.py")
    port_heads = _print_prefixes(ROOT / "esac_tpu_torch" / "scripts" / f"{name}.py")
    if name != "test_esac":
        port_heads |= _print_prefixes(ROOT / "esac_tpu_torch" / "cli.py")
    assert port_heads == jax_heads - {"sharded training: "}


@pytest.mark.parametrize("key", ["e0", "g", "esac", "dense", "topk"])
def test_pipeline_runs_and_prints(pipeline, key):
    lines = pipeline[key].splitlines()
    if key == "e0":
        assert lines[0].startswith("scene=synth0 frames=4 params=")
        assert [ln.split()[:2] for ln in lines[1:5]] == [["iter", str(i)] for i in range(4)]
        assert lines[-1].startswith("saved ") and "final coord L1" in lines[-1]
    elif key == "g":
        assert all("CE" in ln for ln in lines[:4]) and "final CE" in lines[-1]
    elif key == "esac":
        losses = [float(ln.split("E[pose loss]")[1].split()[0]) for ln in lines]
        assert len(losses) == 5 and np.isfinite(losses).all()
    else:
        heads = ["frames: 6", "median rot err:", "median trans err:", "5cm/5deg:",
                 "expert accuracy:", "gating top-1:", "evaluated recall:", "median time:",
                 "wrote "]
        assert [ln[:len(h)] for ln, h in zip(lines, heads)] == heads
        assert "backend=torch-cpu" in lines[7]
        assert f"({16 * (1 if key == 'topk' else 2)} hyps" in lines[7]


@pytest.mark.parametrize("mode", ["dense", "topk"])
def test_eval_json_has_the_jax_scripts_keys(pipeline, mode):
    keys, per_frame = _json_dump_keys(ROOT / "test_esac.py")
    assert tuple(keys) == test_esac.JSON_KEYS and tuple(per_frame) == test_esac.PER_FRAME_KEYS
    record = json.loads((pipeline["dir"] / f"{mode}.json").read_text())
    assert list(record) == keys and list(record["per_frame"]) == per_frame
    assert record["frames"] == 6 and len(record["per_frame"]["expert"]) == 6
    assert record["backend"] == "torch-cpu" and record["refine_iters"] == 8
    assert record["hypotheses_total"] == 16 * (1 if mode == "topk" else 2)
    if mode == "dense":
        assert record["evaluated_recall_pct"] == 100.0


def test_pipeline_checkpoints_reload(pipeline):
    d = pipeline["dir"]
    jax_expert = _jax_script("train_expert")
    jax_gating = _jax_script("train_gating")
    args = argparse.Namespace(size="test", scene="synth0", scenes=["synth0", "synth1"],
                              depth_scale=1.0, map_scale=1.0)
    for m in range(2):
        params, opt_state, cfg, it = load_train_state(d / f"e{m}")
        assert it == 4 and set(cfg) == set(jax_expert._ck_config(args, [0, 0, 0], 0.0)) | {
            "iteration"}
        assert np.isfinite(cfg["final_loss"]) and "scene_center" in params
        e2e, e2e_cfg = load_checkpoint(d / f"esac_expert{m}")
        assert e2e_cfg == {**cfg, "e2e": True} and e2e.keys() == params.keys()
    _, _, g_cfg, it = load_train_state(d / "g")
    assert it == 4 and set(g_cfg) == set(jax_gating._ck_config(args, 0.0)) | {"iteration"}
    assert load_checkpoint(d / "esac_gating")[1] == {**g_cfg, "e2e": True}
    params, opt_state, cfg, it = load_train_state(d / "esac_state")
    assert it == 4 and cfg == {"kind": "esac_state", "scenes": ["synth0", "synth1"],
                               "iteration": 4}
    assert set(params) == {"expert", "gating"}
    assert all(float(s["step"]) == 4.0 for s in opt_state["state"].values())


RESUME_CASES = {
    "expert": ("train_expert", ["synth0"], []),
    "expert_augment": ("train_expert", ["synth1"],
                       ["--augment", "--depth-scale", "1.05", "--map-scale", "0.95"]),
    "expert_reproj": ("train_expert", ["synth0"], ["--loss", "reproj", "--init-iters", "2"]),
    "gating": ("train_gating", ["synth0", "synth1"], []),
    "esac_anneal_clip": ("train_esac", ["synth0", "synth1"],
                         ["--hypotheses", "16", "--scoring-impl", "pallas",
                          "--alpha-start", "0.1", "--clip-norm", "1.0"]),
    "esac_sampled": ("train_esac", ["synth0", "synth1"],
                     ["--hypotheses", "16", "--estimator", "sampled"]),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_stop_and_resume_equals_uninterrupted(pipeline, tmp_path, case):
    """--stop-after 2 then --resume equals 4 uninterrupted iterations, bit
    for bit: the index stream fast-forwards, per-iteration seeds depend on
    the iteration alone, Adam and the schedule come back from the state."""
    name, scenes, extra = RESUME_CASES[case]
    module = PORT[name]
    if name == "train_esac":
        extra = extra + pipeline["ckpts"]
    base = [*scenes, *COMMON, "--iterations", "4", *extra]
    state = "{}_state" if name == "train_esac" else "{}"
    run(module, base + ["--output", str(tmp_path / "full")])
    run(module, base + ["--output", str(tmp_path / "split"), "--stop-after", "2"])
    _, _, _, it = load_train_state(state.format(tmp_path / "split"))
    assert it == 2
    out = run(module, base + ["--output", str(tmp_path / "split"), "--resume"])
    assert out.splitlines()[0 if name != "train_expert" else 1].startswith("resumed ")
    full = load_train_state(state.format(tmp_path / "full"))
    split = load_train_state(state.format(tmp_path / "split"))
    assert full[3] == split[3] == 4

    def flat(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items() for k2, v in flat(sub, f"{prefix}/{k}").items()}
        return {}

    for a, b in ((full[0], split[0]), (full[1]["state"], split[1]["state"])):
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys() and fa
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    assert full[1]["param_groups"] == split[1]["param_groups"]
    # A resume of a finished run trains nothing and keeps the checkpoint.
    again = run(module, base + ["--output", str(tmp_path / "split"), "--resume"])
    assert again.splitlines()[-1].endswith("nothing to do")


@pytest.mark.parametrize("iterations,start_it", [(7, 0), (7, 3), (100, 0)])
def test_schedule_equals_optax(iterations, start_it):
    """The lr each iteration trains at equals optax's cosine_decay_schedule
    at that update count, also after a resume rebuilt the scheduler from
    the saved optimizer state."""
    want = optax.cosine_decay_schedule(1e-3, iterations, 0.05)
    net = torch.nn.Linear(2, 1)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sched = cli.cosine_schedule(opt, iterations)
    for it in range(start_it):
        opt.step()
        sched.step()
    if start_it:  # a resumed run: a fresh optimizer and scheduler from the state
        saved = opt.state_dict()
        opt = torch.optim.Adam(net.parameters(), lr=1e-3)
        opt.load_state_dict(saved)
        sched = cli.cosine_schedule(opt, iterations, start_it)
    for it in range(start_it, iterations + 2):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(it)), rtol=1e-6)
        opt.step()
        sched.step()


def test_trainers_end_at_the_schedules_last_lr(pipeline):
    want = float(optax.cosine_decay_schedule(1e-3, 4, 0.05)(4))
    for ck in ("e0", "g"):
        _, opt_state, _, _ = load_train_state(pipeline["dir"] / ck)
        np.testing.assert_allclose(opt_state["param_groups"][0]["lr"], want, rtol=1e-6)


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser_of(main, monkeypatch):
    def capture(self, argv=None, namespace=None):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as got:
        main([])
    monkeypatch.undo()
    return got.value.parser


def _surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PORT) + ["common_parser"])
def test_flags_equal_the_jax_scripts(name, monkeypatch):
    """Same dests, option strings, defaults, choices, nargs and types as the
    JAX package's, apart from the flags this slice has no counterpart for."""
    if name == "common_parser":
        from esac_tpu import cli as jcli

        ours, ref = cli.common_parser("x"), jcli.common_parser("x")
        cli.add_scoring_impl_arg(ours)
        jcli.add_scoring_impl_arg(ref)
    else:
        ref = _parser_of(_jax_script(name).main, monkeypatch)
        ours = _parser_of(PORT[name].main, monkeypatch)
    want = {k: v for k, v in _surface(ref).items() if k not in ABSENT}
    assert _surface(ours) == want
    assert ABSENT & set(_surface(ref)) and not ABSENT & set(_surface(ours))


@pytest.mark.parametrize("name", sorted(PORT))
def test_scripts_refuse_a_quiet_cpu_run(name, monkeypatch, tmp_path):
    """Without --cpu a script runs on the card, and raises when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_expert": ["synth0"], "train_gating": ["synth0"],
            "train_esac": ["synth0", "--experts", "e", "--gating", "g"],
            "test_esac": ["synth0", "--experts", "e", "--gating", "g"]}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT[name].main(argv + ["--size", "test", "--output" if name != "test_esac"
                                else "--json", str(tmp_path / "x")])


def test_init_from_keeps_the_scene_center(pipeline, tmp_path):
    """--init-from takes another checkpoint's weights but this scene's
    center, with a fresh optimizer (unlike --resume)."""
    d = pipeline["dir"]
    out = run(train_expert, ["synth1", *COMMON, "--iterations", "2", "--init-from",
                             str(d / "e0"), "--output", str(tmp_path / "ft")])
    assert out.splitlines()[0] == f"initialized params from {d / 'e0'}"
    params, opt_state, cfg, it = load_train_state(tmp_path / "ft")
    own, _, own_cfg, _ = load_train_state(d / "e1")
    assert torch.equal(params["scene_center"], own["scene_center"])
    assert cfg["scene_center"] == own_cfg["scene_center"] and it == 2
    assert all(float(s["step"]) == 2.0 for s in opt_state["state"].values())


@pytest.mark.parametrize("build", ["make_expert", "make_gating"])
def test_net_builders_default_to_the_card(build, monkeypatch):
    """Without a device the nets go to the card, and without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ("test", (0.0, 0.0, 0.0)) if build == "make_expert" else ("test", 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(cli, build)(*args)
    assert next(getattr(cli, build)(*args, device="cpu").parameters()).device.type == "cpu"


def test_load_esac_scene_refuses_mixed_sizes(pipeline, tmp_path):
    d = pipeline["dir"]
    params, cfg = load_checkpoint(d / "e1")
    net = cli.make_expert("small", cfg["scene_center"], device="cpu")
    save_checkpoint(tmp_path / "small", net.state_dict(), {**cfg, "size": "small"})
    with pytest.raises(ValueError, match="one size preset"):
        cli.load_esac_scene([d / "e0", tmp_path / "small"], d / "g", 1.0, (0.0, 0.0), "cpu")
    scene, e_cfgs, _ = cli.load_esac_scene([d / "e0", d / "e1"], d / "g", 1.0, (0.0, 0.0),
                                           "cpu")
    assert len(scene["expert"]) == 2 and [c["scene"] for c in e_cfgs] == ["synth0", "synth1"]
