"""The port's graph layer (esac_tpu_torch/lint/{registry,graph_audit,
ledger}.py): the registry's entry points recorded as aten graphs on the
CPU, J1-J3 goldens and near-misses, the resource ledger and the backward
hazard census (J4, J5), R11's coverage gate, and the repo verdict -- the
whole lint over this tree exits 0 and every committed artifact equals
what the tree generates.  The registry is recorded once per session."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import textwrap

import pytest
import torch

from esac_tpu_torch.lint import graph_audit, ledger, registry
from esac_tpu_torch.lint.ast_rules import run_registry_coverage, stale_r11_waivers
from esac_tpu_torch.lint.cli import main as lint_main
from esac_tpu_torch.lint.registry import Entry, mark_backward
from esac_tpu_torch.utils.precision import fixed_sum, hmm

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def traced():
    return graph_audit.trace_entries()


def _entry(fn, make_args, name="golden", pinned=True, grad=False, allow=()):
    """A registry Entry over ``fn``; ``make_args(variant)`` gives its inputs."""
    return Entry(name, pinned=pinned, grad=grad, allow=allow,
                 build=lambda v: (fn, make_args(v)))


def _audit(entry):
    return graph_audit.audit_graphs(entry, *graph_audit.trace_entry(entry))


def _x(v, shape=(4, 64)):
    g = torch.Generator().manual_seed(v)
    return (torch.rand(shape, generator=g) - 0.5 + 0.1 * v,)


# --------------------------------------------------------------------------
# the registry


def test_registry_is_the_jax_registry_plus_the_pallas_function():
    from esac_tpu.lint.registry import ENTRIES as JAX_ENTRIES
    from esac_tpu_torch.lint.gradcheck import WITNESSES

    names = [e.name for e in registry.ENTRIES]
    assert len(names) == len(set(names))
    assert set(names) == {e.name for e in JAX_ENTRIES} | {"scoring_pallas_grad"}
    jax_pinned = {e.name: e.pinned for e in JAX_ENTRIES}
    assert all(e.pinned == jax_pinned.get(e.name, True) for e in registry.ENTRIES)
    # The gradient entries are exactly the gradient witnesses.
    assert {e.name for e in registry.ENTRIES if e.grad} == \
        {w for w in WITNESSES if w.endswith("_grad")}


def test_every_entry_records_a_graph_and_the_tree_audits_clean(traced):
    assert len(traced) == len(registry.ENTRIES)
    for entry, (gm0, gm1) in traced:
        nodes = graph_audit.aten_nodes(gm0)
        assert len(nodes) > 20, entry.name
        assert (graph_audit.backward_start(nodes) < len(nodes)) == entry.grad, entry.name
    findings, stale = graph_audit.run_audit(traced)
    assert findings == [] and stale == []


def test_the_gradient_entries_record_their_backward(traced):
    """The recorder sees the autograd backward: every gradient entry's graph
    has ops after the marker, the select's winner-only backward included."""
    for entry, (gm0, _) in traced:
        if entry.grad:
            nodes = graph_audit.aten_nodes(gm0)
            assert len(nodes) - graph_audit.backward_start(nodes) > 5, entry.name


def test_select_backward_with_only_the_coordinates_requiring_grad():
    """Found by the registry's scoring_fused_select_grad entry: with the
    poses constant, a loss on the select's pose row made the backward ask
    autograd for a gradient through an output no input reaches (a
    RuntimeError).  Now the coordinates' gradient is that of the winner's
    score alone, equal to autograd of the plain formula."""
    from esac_tpu_torch.geometry.rotations import rodrigues
    from esac_tpu_torch.ransac.fused_scoring import (
        soft_inlier_score_select,
        soft_inlier_scores_fused,
    )

    g = torch.Generator().manual_seed(0)
    coords = (torch.rand(1, 16, 3, generator=g) + torch.tensor([0.0, 0.0, 2.0]))
    pixels = torch.rand(16, 2, generator=g) * 64
    Rs = rodrigues(torch.rand(1, 4, 3, generator=g) * 0.1)
    ts = torch.zeros(1, 4, 3)
    f, c = torch.tensor([60.0]), torch.tensor([32.0, 24.0])
    x = coords.clone().requires_grad_(True)
    best, score, pose = soft_inlier_score_select(Rs, ts, x, pixels, f, c, 10.0, 0.5)
    (score.sum() + pose.sum()).backward()
    y = coords.clone().requires_grad_(True)
    w = int(best[0])
    soft_inlier_scores_fused(Rs[:, w:w + 1], ts[:, w:w + 1], y, pixels, f, c,
                             10.0, 0.5).sum().backward()
    assert torch.equal(x.grad, y.grad)


# --------------------------------------------------------------------------
# J1-J3


def test_j1_disallowed_ops_and_an_allowance():
    def fn(x):
        a = torch.nonzero(x > 0)
        b = x[x > 0]
        c = torch.linalg.solve(x[:, :4] + 4 * torch.eye(4), x[:, :1])
        return a.sum() + b.sum() + c.sum() + x.max().item()

    found, _ = _audit(_entry(fn, lambda v: _x(0), pinned=False))
    keys = {f.text for f in found if f.rule == "J1"}
    assert {"nonzero", "bool_index", "_local_scalar_dense"} <= keys
    assert "_linalg_solve_ex" in keys
    allow = (("J1", "nonzero", "reviewed"),)
    found, used = _audit(_entry(fn, lambda v: _x(0), pinned=False, allow=allow))
    assert "nonzero" not in {f.text for f in found} and used == {("J1", "nonzero")}


def test_j2_a_branch_on_the_data_is_caught_and_where_is_not():
    def branchy(x):
        return x * 2 if float(x.sum()) > 0 else x + 1

    found, _ = _audit(_entry(branchy, lambda v: (torch.full((4,), 1.0 - 2 * v),),
                             pinned=False))
    assert [f.rule for f in found] == ["J1", "J2"]  # the host read, the branch

    def selecty(x):
        return torch.where(x.sum() > 0, x * 2, x + 1)

    found, _ = _audit(_entry(selecty, lambda v: (torch.full((4,), 1.0 - 2 * v),),
                             pinned=False))
    assert found == []


def test_j3_unpinned_products_long_sums_and_half_in_a_pinned_forward():
    def bad(x):
        return torch.matmul(x, x.T).sum() + x.sum(-1).sum() + x.bfloat16().float().sum()

    found, _ = _audit(_entry(bad, _x))
    assert {f.text for f in found if f.rule == "J3"} == {"mm", "sum:64", "half", "sum:256"}

    def good(x):
        return fixed_sum(hmm(x, x.T).reshape(-1), dim=0) + fixed_sum(x, dim=-1).sum()

    assert _audit(_entry(good, _x)) == ([], set())
    # Unpinned entries and a gradient entry's backward are not held to it.
    assert _audit(_entry(bad, _x, pinned=False))[0] == []

    def backward_mm(x):
        y = x.detach().requires_grad_(True)
        loss = fixed_sum((y * y).reshape(-1), dim=0)
        (gr,) = torch.autograd.grad(mark_backward(loss), [y])
        return gr @ gr.T

    assert _audit(_entry(backward_mm, _x, grad=True))[0] == []


# --------------------------------------------------------------------------
# J4 / J5: the ledger


def _log_entry(eps: float):
    def fn(x):
        y = x.detach().abs().requires_grad_(True)
        loss = torch.log(y + eps).sum() if eps else torch.log(y).sum()
        return torch.autograd.grad(mark_backward(loss), [y])

    return _entry(fn, _x, name="log_grad", pinned=False, grad=True)


def test_j5_an_eps_free_division_in_a_backward_is_a_new_unguarded_site():
    guarded, unguarded = _log_entry(1e-6), _log_entry(0.0)
    committed = ledger.build_ledger([(guarded, graph_audit.trace_entry(guarded))])
    current = ledger.build_ledger([(unguarded, graph_audit.trace_entry(unguarded))])
    assert committed["log_grad"]["grad_hazards"]["div"] == {"guarded": 1, "unguarded": 0}
    assert current["log_grad"]["grad_hazards"]["div"] == {"guarded": 0, "unguarded": 1}
    found, _ = ledger.diff_ledger(committed, current)
    assert [f.rule for f in found] == ["J5"]
    assert ledger.diff_ledger(committed, committed) == ([], [])


def test_ledger_round_trip_and_regressions(tmp_path, traced):
    current = ledger.build_ledger(traced)
    path = tmp_path / "ledger.json"
    ledger.write_ledger(path, current)
    assert ledger.load_ledger(path) == json.loads(json.dumps(current))
    assert ledger.diff_ledger(current, current) == ([], [])
    grown = json.loads(json.dumps(current))
    grown["dsac_infer"]["flops"] = int(current["dsac_infer"]["flops"] * 1.3)
    grown["dsac_infer"]["peak_intermediate_bytes"] += 1
    grown["dsac_infer"]["ops"]["mm"] = 1
    found, stale = ledger.diff_ledger(current, grown)
    assert sorted(f.text.split(":")[0] for f in found) == ["flops", "mm"]
    assert any("dsac_infer" in n for n in stale)
    found, _ = ledger.diff_ledger({}, current)
    assert {f.text for f in found} == {"missing-entry"}
    stats = current["esac_infer_routed_frames"]
    assert stats["flops"] > stats["peak_intermediate_bytes"] > 0
    assert {"top_intermediates", "ops", "nodes"} <= set(stats)


# --------------------------------------------------------------------------
# R11


def _write(root: pathlib.Path, rel: str, text: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))


def test_r11_every_entry_point_is_registered_or_waived(tmp_path):
    _write(tmp_path, "esac_tpu_torch/ransac/kernel.py", """\
        def dsac_infer(x):
            return x

        def dsac_infer_new(x):
            return x

        def make_serve_fn(cfg):
            def run(batch):
                return batch
            return run

        def make_config(cfg):
            return cfg
        """)
    _write(tmp_path, "esac_tpu_torch/lint/registry.py", """\
        from esac_tpu_torch.ransac.kernel import dsac_infer

        ENTRIES = (dsac_infer,)
        R11_WAIVED = {"make_serve_fn": "a closure", "gone_fn": "removed"}
        """)
    found = run_registry_coverage(tmp_path)
    assert [(f.rule, f.line) for f in found] == [("R11", 4)]
    assert [n.split("'")[1] for n in stale_r11_waivers(tmp_path)] == ["gone_fn"]
    assert stale_r11_waivers(REPO) == [] and run_registry_coverage(REPO) == []


# --------------------------------------------------------------------------
# the repo verdict


def test_the_lint_over_the_tree_exits_0(traced, capsys):
    """The whole lint (static rules, artifact gates, graph layer) in JSON
    mode: exit 0, one object per line (none), the summary and no stale
    note on stderr."""
    assert lint_main(["--format", "json"]) == 0
    out = capsys.readouterr()
    assert all(json.loads(line) for line in out.out.splitlines())
    assert "torch-lint: 0 finding(s) over tree (incl. lock graph, fault taxonomy, " \
        "graph audit + ledger)" in out.err
    assert "stale" not in out.err


def test_committed_ledger_equals_what_the_tree_generates(tmp_path, traced):
    out = tmp_path / "graph_ledger.json"
    ledger.write_ledger(out, ledger.build_ledger(traced))
    assert out.read_text() == (REPO / ledger.LEDGER_NAME).read_text()


def test_entry_is_a_frozen_record():
    e = registry.ENTRIES[0]
    with pytest.raises(dataclasses.FrozenInstanceError):
        e.name = "x"
