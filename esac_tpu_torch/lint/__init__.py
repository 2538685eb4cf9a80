"""torch-lint: the port's own invariants, checked (counterpart of
``esac_tpu/lint/``).

The port rests on invariants that otherwise live only as prose: products
and long sums through ``hmm`` / ``fixed_sum``, TF32 off and no quiet CPU
fallback (``utils/precision.py``), grad-safe geometry through
``safe_norm`` / ``safe_sqrt``, pooled pinned buffers rewritten only after
their dispatch is fenced (``serve/batching.py``), and the serving fleet's
lock order and typed fault taxonomy.  This package checks them:

- **Static rules** (pure ``ast``, no torch import): R1-R6, R8 and the
  registry-coverage gate R11 (:mod:`~.ast_rules`), R10
  (:mod:`~.concurrency`), R12/R13
  (:mod:`~.lockgraph`, with the committed ``lock_graph.json``), R14/R15
  (:mod:`~.gradsafety`) and R16-R18 (:mod:`~.faultflow`, with the
  committed ``fault_taxonomy.json``).  R7 and R9 have no counterpart
  (``findings.RULES`` says why).
- **Graph layer** (torch on the CPU): the registry's entry points
  (:mod:`~.registry`) recorded as aten graphs and audited for J1-J3
  (:mod:`~.graph_audit`); the resource ledger and the backward hazard
  census, J4/J5 (:mod:`~.ledger`, with the committed
  ``graph_ledger.json``).
- **Runtime witnesses**: the degenerate-input gradient witness
  (:mod:`~.gradcheck`, with the committed ``grad_corpus.json``; on the
  card it runs both hand-written kernels) and the lock / outcome
  witnesses (:mod:`~.witness`).

Run ``python -m esac_tpu_torch.lint`` (full tree) or ``--changed``;
``--format json`` prints one object per finding per line.  Inline
suppressions are ``# torch-lint: disable=RULE(reason)``; the baseline is
``esac_tpu_torch/lint/baseline.json`` (empty).
"""

from esac_tpu_torch.lint.ast_rules import run_python_rules, run_registry_coverage
from esac_tpu_torch.lint.concurrency import run_concurrency_rules
from esac_tpu_torch.lint.faultflow import run_faultflow_rules
from esac_tpu_torch.lint.findings import RULES, Finding
from esac_tpu_torch.lint.gradsafety import run_gradsafety_rules
from esac_tpu_torch.lint.lockgraph import run_lock_rules
from esac_tpu_torch.lint.suppress import Baseline

__all__ = [
    "Finding",
    "RULES",
    "run_python_rules",
    "run_concurrency_rules",
    "run_faultflow_rules",
    "run_gradsafety_rules",
    "run_lock_rules",
    "run_registry_coverage",
    "Baseline",
    "run_layer1",
]


def run_layer1(root, files=None):
    """Every static finding for the tree at ``root`` (inline suppressions
    applied, the baseline not: callers decide).  The lock, fault-flow,
    grad-safety and registry-coverage passes are tree-global, and skipped
    when a scoped run touched none of their files; the committed-artifact
    diffs and the graph layer ride the CLI."""
    findings = run_python_rules(root, files=files)
    findings += run_concurrency_rules(root, files=files)
    findings += run_lock_rules(root, files=files)
    findings += run_faultflow_rules(root, files=files)
    findings += run_gradsafety_rules(root, files=files)
    findings += run_registry_coverage(root, files=files)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
