"""The port's static lint rules (esac_tpu_torch/lint/): a golden that fires
and a near-miss that does not for every port rule of the AST layer and
the grad-safety pass, built in tmp_path trees laid out like the port;
suppressions, the baseline, the rule catalog, and the two lints keeping
out of each other's way.  Pure ``ast``: no device, no JAX trace."""

from __future__ import annotations

import pathlib
import textwrap

import pytest

from esac_tpu_torch.lint import RULES, run_layer1
from esac_tpu_torch.lint.ast_rules import run_python_rules
from esac_tpu_torch.lint.findings import NO_COUNTERPART, Finding
from esac_tpu_torch.lint.gradsafety import run_gradsafety_rules
from esac_tpu_torch.lint.suppress import (
    Baseline,
    declared_suppressions,
    parse_suppressions,
    record_usage,
    stale_suppressions,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _write(root: pathlib.Path, rel: str, text: str) -> str:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return rel


def _rules(findings, rule):
    return [(f.path, f.line) for f in findings if f.rule == rule]


# --------------------------------------------------------------------------
# one golden and one near-miss per AST rule


GOLDENS = {
    "R1": ("esac_tpu_torch/models/consts.py", """\
        import torch

        ONES = torch.ones(3, device="cuda")
        GRID = torch.arange(4).cuda()
        N = torch.cuda.device_count()
        """, 3),
    "R2": ("esac_tpu_torch/geometry/norms.py", """\
        import torch

        def length(x):
            return torch.linalg.norm(x, dim=-1) + x.norm(dim=-1)

        def root(x):
            return torch.sqrt(x)
        """, 3),
    "R3": ("esac_tpu_torch/ransac/kernel.py", """\
        import torch

        def _solve(A, b):
            return torch.linalg.solve(A, b)

        def dsac_infer(A, b):
            return _solve(A, b) + torch.inverse(A)
        """, 2),
    "R4": ("esac_tpu_torch/geometry/algebra.py", """\
        import torch
        import torch.nn.functional as F

        def compose(R, t, w):
            return R @ t, torch.matmul(R, t), torch.einsum("ij,j->i", R, t), F.linear(t, w)
        """, 4),
    "R5": ("esac_tpu_torch/serve/cfg.py", """\
        import dataclasses

        @dataclasses.dataclass
        class LaneConfig:
            depth: int = 2
        """, 1),
    "R6": ("esac_tpu_torch/serve/pick.py", """\
        import torch

        def device():
            return "cuda" if torch.cuda.is_available() else "cpu"
        """, 1),
    "R8": ("esac_tpu_torch/serve/stage.py", """\
        import torch

        def pump(staging, batches, dev):
            for frames in batches:
                tree = staging.stage(frames, 4)
                call(tree)

        def copy_then_write(x, dev):
            y = x.to(dev, non_blocking=True)
            x[0] = 1.0
            return y
        """, 2),
}

NEAR_MISSES = {
    "R1": ("esac_tpu_torch/models/consts.py", """\
        import torch

        ONES = torch.ones(3)
        PI = torch.tensor(3.14159, dtype=torch.float64)

        def ones(device):
            return torch.ones(3, device="cuda").cuda()
        """),
    "R2": ("esac_tpu_torch/geometry/norms.py", """\
        import numpy as np
        import torch

        from esac_tpu_torch.utils.num import safe_norm

        def length(x):
            return safe_norm(x) + torch.sqrt(x * x + 1e-12) + np.linalg.norm([1.0])
        """),
    "R3": ("esac_tpu_torch/ransac/kernel.py", """\
        import torch

        def offline_report(A, b):
            return torch.linalg.solve(A, b)

        def dsac_infer(A, b):
            return A * b
        """),
    "R4": ("esac_tpu_torch/ransac/fused_scoring.py", """\
        import torch

        def scores(a, b):
            return torch.matmul(a, b)
        """),
    "R5": ("esac_tpu_torch/serve/cfg.py", """\
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class LaneConfig:
            depth: int = 2

        @dataclasses.dataclass
        class LaneStats:
            n: int = 0
        """),
    "R6": ("esac_tpu_torch/utils/precision.py", """\
        import torch

        def resolve_device(device=None):
            dev = torch.device("cuda" if device is None else device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA")
            return dev

        def require_card():
            if not torch.cuda.is_available():
                raise RuntimeError("no GPU to drive")
        """),
    "R8": ("esac_tpu_torch/serve/stage.py", """\
        import torch

        def pump(staging, batches, dev):
            staged = staging.stage(batches[0], 4)
            for i in range(len(batches)):
                out = call(staged)
                done = record()
                if i + 1 < len(batches):
                    staged = staging.stage(batches[i + 1], 4)
                done.synchronize()

        def copy_then_write(x, dev):
            y = x.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            x[0] = 1.0
            return y
        """),
}


@pytest.mark.parametrize("rule", sorted(GOLDENS))
def test_ast_rule_golden_fires(tmp_path, rule):
    rel, text, n = GOLDENS[rule]
    _write(tmp_path, rel, text)
    hits = _rules(run_python_rules(tmp_path), rule)
    assert len(hits) == n and {p for p, _ in hits} == {rel}, hits


@pytest.mark.parametrize("rule", sorted(NEAR_MISSES))
def test_ast_rule_near_miss_is_clean(tmp_path, rule):
    rel, text = NEAR_MISSES[rule]
    _write(tmp_path, rel, text)
    assert _rules(run_python_rules(tmp_path), rule) == []


def test_r6_covers_chip_smoke_and_r8_stays_in_its_scope(tmp_path):
    _write(tmp_path, "chip_smoke.py", """\
        import torch

        DEV = "cuda" if torch.cuda.is_available() else "cpu"
        """)
    _write(tmp_path, "esac_tpu_torch/geometry/stage.py", GOLDENS["R8"][1])
    found = run_python_rules(tmp_path)
    assert _rules(found, "R6") == [("chip_smoke.py", 3)]
    assert _rules(found, "R8") == []
    # tests/ is exempt from every rule.
    _write(tmp_path, "tests/test_x.py", GOLDENS["R1"][1])
    assert not [f for f in run_python_rules(tmp_path) if f.path.startswith("tests/")]


R8_HELPERS = """\
    class Pump:
        def _stage(self, frames):
            return self._staging.stage(frames, 4)

        def _wait(self, done):
            done.synchronize()

        def _land(self, done):
            self._wait(done)

        def run(self, batches):
            for frames in batches:
                self._stage(frames)
                {land}
    """


@pytest.mark.parametrize("land, fires", [("self._land(None)", False), ("pass", True)],
                         ids=["fenced", "unfenced"])
def test_r8_follows_the_files_own_staging_and_fencing_helpers(tmp_path, land, fires):
    """A staging method called through ``self`` is a staging, and a wait
    two calls deep a fence (the dispatcher's ``_stage`` / ``_land``)."""
    rel = _write(tmp_path, "esac_tpu_torch/serve/pump.py", R8_HELPERS.format(land=land))
    assert _rules(run_python_rules(tmp_path), "R8") == ([(rel, 13)] if fires else [])


def test_r3_follows_the_call_graph_across_modules(tmp_path):
    _write(tmp_path, "esac_tpu_torch/__init__.py", "")
    _write(tmp_path, "esac_tpu_torch/geometry/__init__.py", "")
    _write(tmp_path, "esac_tpu_torch/geometry/solve.py", """\
        import torch

        def normal_equations(A, g):
            return torch.linalg.cholesky(A), g
        """)
    _write(tmp_path, "esac_tpu_torch/ransac/esac.py", """\
        from esac_tpu_torch.geometry.solve import normal_equations

        def esac_train_loss_frames(A, g):
            return normal_equations(A, g)
        """)
    assert _rules(run_python_rules(tmp_path), "R3") == [
        ("esac_tpu_torch/geometry/solve.py", 4)]


# --------------------------------------------------------------------------
# R14 / R15: the grad-safety pass


def _grad_tree(tmp_path, body: str):
    """A one-module differentiated scope, rooted by a witness module that
    names its entry (as gradcheck.py names the port's)."""
    _write(tmp_path, "esac_tpu_torch/__init__.py", "")
    _write(tmp_path, "esac_tpu_torch/geometry/__init__.py", "")
    _write(tmp_path, "esac_tpu_torch/geometry/mod.py", body)
    _write(tmp_path, "esac_tpu_torch/lint/gradcheck.py", """\
        def _make():
            from esac_tpu_torch.geometry.mod import entry

            return entry
        """)


def test_r14_hazards_in_every_spelling(tmp_path):
    _grad_tree(tmp_path, """\
        import torch

        def entry(x, y):
            a = x / y
            b = torch.div(x, y)
            c = torch.acos(x)
            d = x.log()
            e = torch.rsqrt(y)
            f = y ** 0.5
            g = y.pow(-1)
            h = x.reciprocal()
            return a + b + c + d + e + f + g + h
        """)
    found = run_gradsafety_rules(tmp_path)
    assert [f.line for f in found if f.rule == "R14"] == [4, 5, 6, 7, 8, 9, 10, 11]


def test_r14_guards_are_credited(tmp_path):
    _grad_tree(tmp_path, """\
        import math

        import torch

        from esac_tpu_torch.utils.num import safe_norm

        MIN_DEPTH = 0.1

        def entry(x, y):
            a = x / (y + 1e-12)
            b = x / torch.clamp(y, min=MIN_DEPTH)
            c = torch.acos(torch.clamp(x, -1.0, 1.0))
            d = torch.log(x.clamp_min(1e-9))
            e = x / safe_norm(y)
            f = x / torch.where(y == 0, torch.ones_like(y), y)
            g = (x * x + 1e-12) ** 0.5
            h = x * (180.0 / math.pi) / x.shape[-1]
            return a + b + c + d + e + f + g + h
        """)
    assert run_gradsafety_rules(tmp_path) == []


def test_r14_half_clamped_acos_still_fires_and_r15_in_a_where_branch(tmp_path):
    _grad_tree(tmp_path, """\
        import torch

        def entry(x, y):
            a = torch.acos(torch.clamp(x, min=-1.0))
            b = torch.where(y == 0, torch.zeros_like(x), x / y)
            return a + b
        """)
    found = run_gradsafety_rules(tmp_path)
    assert [(f.rule, f.line) for f in found] == [("R14", 4), ("R15", 5)]


def test_autograd_function_pairs_are_roots_without_a_witness(tmp_path):
    _write(tmp_path, "esac_tpu_torch/__init__.py", "")
    _write(tmp_path, "esac_tpu_torch/ransac/fn.py", """\
        import torch

        def _helper(g, y):
            return g / y

        class Scores(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.log()

            @staticmethod
            def backward(ctx, g):
                return _helper(g, ctx.y)

        def unreached(x):
            return 1.0 / x
        """)
    found = run_gradsafety_rules(tmp_path)
    assert sorted((f.rule, f.line) for f in found) == [("R14", 4), ("R14", 9)]


# --------------------------------------------------------------------------
# suppressions, baseline, catalog


def test_torch_lint_directive_suppresses_and_graft_lint_does_not(tmp_path):
    _write(tmp_path, "esac_tpu_torch/serve/pick.py", """\
        import torch

        A = "cuda" if torch.cuda.is_available() else "cpu"  # torch-lint: disable=R6(reviewed)
        B = "cuda" if torch.cuda.is_available() else "cpu"  # graft-lint: disable=R6(JAX's word)
        """)
    with record_usage() as used:
        found = run_python_rules(tmp_path)
    assert _rules(found, "R6") == [("esac_tpu_torch/serve/pick.py", 4)]
    assert used == {("esac_tpu_torch/serve/pick.py", 3, "R6")}
    per_line, _ = parse_suppressions("x = 1  # torch-lint: disable=R4(a), R6(b (c) d)\n")
    assert per_line == {1: {"R4", "R6"}}


def test_stale_suppression_is_reported(tmp_path):
    _write(tmp_path, "esac_tpu_torch/serve/ok.py", """\
        X = 1  # torch-lint: disable=R6(nothing fires here)
        """)
    with record_usage() as used:
        run_layer1(tmp_path)
    notes = stale_suppressions(declared_suppressions(tmp_path), used)
    assert len(notes) == 1 and "esac_tpu_torch/serve/ok.py:1" in notes[0]


def test_baseline_round_trip_masks_and_reports_stale(tmp_path):
    f = Finding("R4", "esac_tpu_torch/geometry/a.py", 3, "y = a @ b", "msg")
    path = tmp_path / "baseline.json"
    Baseline.from_findings([f]).write(path)
    kept, stale = Baseline.load(path).apply([f])
    assert kept == [] and stale == []
    kept, stale = Baseline.load(path).apply([])
    assert [e.rule for e in stale] == ["R4"]
    committed = Baseline.load(REPO / "esac_tpu_torch/lint/baseline.json")
    assert committed.entries == []


def test_rule_catalog_marks_r7_and_r9_as_no_counterpart():
    from esac_tpu.lint.findings import RULES as JAX_RULES

    assert RULES["R7"][0] == NO_COUNTERPART and RULES["R9"][0] == NO_COUNTERPART
    assert "relay" in RULES["R7"][1] and "_build.py" in RULES["R9"][1]
    # Every JAX rule id has its port form (or its "no counterpart") here.
    assert set(JAX_RULES) == set(RULES)


def test_list_rules_prints_every_rule(capsys):
    from esac_tpu_torch.lint.cli import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"{rule}: " in out for rule in RULES)


# --------------------------------------------------------------------------
# the two lints keep out of each other's way


def test_port_files_add_no_jax_finding_and_no_graft_directive():
    """The JAX lint scans the whole tree outside tests/ for R1 and R8 and
    sweeps every `graft-lint` directive; the port's files add nothing to
    either, and the port's directives are invisible to it."""
    from esac_tpu.lint.ast_rules import run_python_rules as jax_rules
    from esac_tpu.lint.suppress import declared_suppressions as jax_declared

    port = sorted(p.relative_to(REPO).as_posix()
                  for p in (REPO / "esac_tpu_torch").rglob("*.py")
                  if "build" not in p.parts) + ["chip_smoke.py"]
    assert jax_rules(REPO, files=port) == []
    assert not [d for d in jax_declared(REPO, files=port)]
    assert declared_suppressions(REPO, files=port), "the port carries reviewed directives"
