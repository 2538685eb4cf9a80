"""The port's degenerate-input gradient witness (esac_tpu_torch/lint/
gradcheck.py) held against the JAX package's, and the repo verdict: the
port's lint over this tree exits 0, its committed artifacts equal what the
tree generates, and every torch-lint directive in the tree is live."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from esac_tpu_torch.lint import gradcheck, run_layer1
from esac_tpu_torch.lint.cli import main as lint_main
from esac_tpu_torch.lint.cli import stale_findings
from esac_tpu_torch.lint.suppress import record_usage

REPO = pathlib.Path(__file__).resolve().parent.parent

# Scores of one hypothesis sum 16 sigmoids in f32 in each package.
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def port_run():
    record = {}
    verdicts = gradcheck.run_gradcheck(device="cpu", record=record)
    return verdicts, record


def test_corpus_equals_the_jax_corpus_case_for_case():
    from esac_tpu.lint.gradcheck import default_corpus as jax_default

    port = gradcheck.default_corpus()["cases"]
    assert port == jax_default()["cases"]
    assert port == json.loads((REPO / ".grad_corpus.json").read_text())["cases"]
    committed = REPO / gradcheck.GRAD_CORPUS_NAME
    assert gradcheck.load_corpus(committed) == gradcheck.default_corpus()
    assert len(port) == 8


def test_witness_set_is_the_jax_set_plus_the_pallas_function():
    from esac_tpu.lint.gradcheck import WITNESSES as JAX_WITNESSES

    assert set(gradcheck.WITNESSES) == set(JAX_WITNESSES) | {"scoring_pallas_grad"}
    assert set(gradcheck.KERNEL_WITNESSES) == {"scoring_pallas_grad",
                                              "scoring_fused_select_grad"}


def test_every_witness_finite_on_every_case_on_the_cpu(port_run):
    verdicts, _ = port_run
    bad = [(entry, case) for entry, cases in verdicts.items() if entry != "clean"
           for case, rec in cases.items()
           if not (rec["outputs_finite"] and rec["grads_finite"])]
    assert verdicts["clean"] and bad == []
    assert set(verdicts) == set(gradcheck.WITNESSES) | {"clean"}
    for entry in gradcheck.WITNESSES:
        assert set(verdicts[entry]) == set(gradcheck.default_corpus()["cases"])
    json.dumps(verdicts)


def test_the_select_backward_reaches_every_input(port_run):
    _, record = port_run
    for case in gradcheck.default_corpus()["cases"]:
        _, grads, _ = record[("scoring_fused_select_grad", case)]
        assert all(grads[k] is not None for k in ("coords", "rvecs", "tvecs")), case
        # Only the winner's row of the hypotheses gets a gradient.
        rows = (grads["rvecs"][0].abs().sum(-1) > 0).sum()
        assert int(rows) <= 1, case


def test_planted_nan_is_caught_by_the_witness():
    """The witness must be able to fail: a bare sqrt of a squared length
    (the hazard R2 polices) on the coincident-points case has a NaN
    gradient (inf times 0).  (torch.linalg.norm itself defines a zero
    subgradient at 0.)"""

    def run(coords, pixels, f, c, rvec, tvec, offs, kept):
        x = coords.detach().clone().requires_grad_(True)
        d = x - x[0]
        loss = torch.sqrt((d * d).sum(-1)).sum()
        (g,) = torch.autograd.grad(loss, [x])
        return {"loss": loss}, {"coords": g}

    corpus = gradcheck.load_corpus(REPO / gradcheck.GRAD_CORPUS_NAME)
    arrays = gradcheck.case_arrays(corpus["cases"]["coincident_points"], "cpu")
    v = gradcheck.check_case(run, arrays)
    assert v == {"outputs_finite": True, "grads_finite": False}
    verdicts = gradcheck.run_gradcheck(corpus, {"planted": lambda: run}, device="cpu")
    assert verdicts["clean"] is False
    assert verdicts["planted"]["coincident_points"]["grads_finite"] is False


def test_scoring_witnesses_agree_with_the_jax_witnesses(port_run):
    """The same corpus arrays through both packages' scoring witnesses:
    scores within SCORE_TOL ("errmap" and "fused" against their JAX twins,
    the "pallas" Function against JAX's fused formula), and the select's
    winner and best score (JAX's plain fold)."""
    import jax

    from esac_tpu.lint import gradcheck as jg

    _, record = port_run
    jax_fns = {impl: jg._make_scoring_grad(impl)() for impl in ("errmap", "fused")}
    jax_select = jg._make_scoring_fused_select_grad()
    twins = {"scoring_errmap_grad": "errmap", "scoring_fused_grad": "fused",
             "scoring_pallas_grad": "fused"}
    for case_name, case in sorted(gradcheck.default_corpus()["cases"].items()):
        arrays = jg._case_arrays(case)
        got = {impl: np.asarray(fn(**arrays)[0]["scores"]) for impl, fn in jax_fns.items()}
        for port_name, impl in twins.items():
            out, _, _ = record[(port_name, case_name)]
            np.testing.assert_allclose(out["scores"].detach().numpy(), got[impl],
                                       err_msg=f"{port_name} {case_name}", **SCORE_TOL)
        j_out, _ = jax_select(**arrays)
        out, _, _ = record[("scoring_fused_select_grad", case_name)]
        np.testing.assert_allclose(float(out["best_score"].detach()), float(j_out["best_score"]),
                                   **SCORE_TOL)
        scores = got["fused"]
        top = np.sort(scores)[::-1]
        if top[0] - top[1] > SCORE_TOL["atol"] + SCORE_TOL["rtol"] * abs(top[0]):
            assert int(out["best_idx"]) == int(j_out["best_idx"]), case_name
    assert jax.devices()[0].platform == "cpu"


# --------------------------------------------------------------------------
# the repo verdict


def test_the_tree_is_clean_and_every_directive_is_live():
    with record_usage() as used:
        findings = run_layer1(REPO)
    assert findings == []
    assert stale_findings(REPO, used) == []
    # The static rules and the artifact gates; the graph layer's verdict
    # is test_torch_lint_graph.py's.
    assert lint_main(["--root", str(REPO), "--no-graph"]) == 0


@pytest.mark.parametrize("artifact", ["lock_graph", "fault_taxonomy", "grad_corpus"])
def test_committed_artifact_equals_what_the_tree_generates(tmp_path, artifact):
    from esac_tpu_torch.lint import faultflow, lockgraph

    name, write = {
        "lock_graph": (lockgraph.LOCK_GRAPH_NAME,
                       lambda p: lockgraph.write_graph(p, lockgraph.build_graph(REPO))),
        "fault_taxonomy": (faultflow.FAULT_TAXONOMY_NAME,
                           lambda p: faultflow.write_taxonomy(
                               p, faultflow.build_taxonomy(REPO))),
        "grad_corpus": (gradcheck.GRAD_CORPUS_NAME, gradcheck.write_corpus),
    }[artifact]
    out = tmp_path / "generated.json"
    write(out)
    assert out.read_text() == (REPO / name).read_text()
