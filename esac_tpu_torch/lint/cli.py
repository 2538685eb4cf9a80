"""The port's lint CLI: ``python -m esac_tpu_torch.lint`` (counterpart of
``esac_tpu/lint/cli.py``).

Exit codes: 0 clean, 1 findings, 2 internal error.

Modes
-----
- default            : every static rule over the port (R1-R6, R8, R10-R18),
                       the lock-graph diff against the committed
                       esac_tpu_torch/lint/lock_graph.json, the taxonomy
                       diff against fault_taxonomy.json, and the graph
                       layer: the registry's entries recorded on the CPU,
                       J1-J3, and the ledger diff against
                       graph_ledger.json (J4, J5); a full-tree run also
                       sweeps for stale inline suppressions, baseline
                       entries, R11 waivers and graph allowances
- ``--changed``      : the rules over git-modified / untracked files only;
                       the lock-graph and fault-flow passes only when a
                       serve / registry / obs / fleet / retrieval / lint
                       file changed, the grad-safety pass only when a
                       geometry / ransac / train / lint file changed, the
                       graph layer only when a package file changed
- ``PATHS...``       : the rules over the given files / directories (the
                       graph layer when they include package files)
- ``--no-graph``     : skip the graph layer
- ``--format json``  : one JSON object per finding per line on stdout
                       (stable ``id``); notes and the summary on stderr
- ``--list-rules``   : the rule catalog, R7 and R9 marked "no counterpart"
- ``--write-baseline``: regenerate esac_tpu_torch/lint/baseline.json from
                       the current findings (review before committing)
- ``--write-lock-graph``: regenerate lock_graph.json (review the edges)
- ``--write-taxonomy``: regenerate fault_taxonomy.json (review the error
                       catalog and the raise -> outcome edges)
- ``--write-ledger`` : regenerate graph_ledger.json from the current
                       traces (review the numbers)

The static layer imports nothing it checks; the graph layer runs the
registry's entries on the CPU.  Neither touches a device.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

from esac_tpu_torch.lint import faultflow, lockgraph, run_layer1
from esac_tpu_torch.lint.ast_rules import stale_r11_waivers
from esac_tpu_torch.lint.findings import RULES, Finding
from esac_tpu_torch.lint.suppress import (
    Baseline,
    declared_suppressions,
    record_usage,
    stale_suppressions,
)

BASELINE_NAME = "esac_tpu_torch/lint/baseline.json"
# The lint's own package: its docstrings and test fixtures hold
# directive-shaped text that documents, not suppresses.
LINT_PACKAGE = "esac_tpu_torch/lint/"


def find_repo_root(start: pathlib.Path | None = None) -> pathlib.Path:
    p = (start or pathlib.Path.cwd()).resolve()
    for cand in (p, *p.parents):
        if (cand / "esac_tpu_torch").is_dir() and (
                (cand / "pyproject.toml").exists() or (cand / ".git").exists()):
            return cand
    return p


def _changed_files(root: pathlib.Path) -> list[str]:
    """Tracked-modified + staged + untracked paths, repo-relative."""
    out: set[str] = set()
    for args in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        res = subprocess.run(
            args, cwd=root, capture_output=True, text=True, check=False
        )
        if res.returncode == 0:
            out.update(line for line in res.stdout.splitlines() if line)
    return sorted(out)


def _expand_paths(root: pathlib.Path, paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        full = (root / p) if not pathlib.Path(p).is_absolute() else pathlib.Path(p)
        if full.is_dir():
            files.extend(
                f.relative_to(root).as_posix()
                for f in sorted(full.rglob("*.py"))
            )
        else:
            files.append(full.resolve().relative_to(root.resolve()).as_posix())
    return files


def _note(msg: str) -> None:
    print(msg, file=sys.stderr)


def _audited(root: pathlib.Path) -> bool:
    """Trees that carry the lint package carry its committed artifacts."""
    return (root / LINT_PACKAGE / "__init__.py").exists()


def _write(args, root) -> int | None:
    """The --write-* modes; None when none was asked."""
    try:
        if args.write_lock_graph:
            graph = lockgraph.build_graph(root)
            lockgraph.write_graph(root / lockgraph.LOCK_GRAPH_NAME, graph)
            _note(f"torch-lint: wrote {len(graph['nodes'])} lock node(s) / "
                  f"{len(graph['edges'])} edge(s) to {lockgraph.LOCK_GRAPH_NAME} "
                  "-- review the diff before committing")
            return 0
        if args.write_taxonomy:
            taxonomy = faultflow.build_taxonomy(root)
            faultflow.write_taxonomy(root / faultflow.FAULT_TAXONOMY_NAME, taxonomy)
            _note(f"torch-lint: wrote {len(taxonomy['errors'])} error class(es) / "
                  f"{len(taxonomy['edges'])} raise->outcome edge(s) to "
                  f"{faultflow.FAULT_TAXONOMY_NAME} -- review before committing")
            return 0
        if args.write_ledger:
            from esac_tpu_torch.lint import graph_audit, ledger

            entries = ledger.build_ledger(graph_audit.trace_entries())
            ledger.write_ledger(root / ledger.LEDGER_NAME, entries)
            _note(f"torch-lint: wrote {len(entries)} ledger entries to "
                  f"{ledger.LEDGER_NAME} -- review the numbers before committing")
            return 0
    except Exception as e:
        _note(f"torch-lint: internal error writing an artifact: {e!r}")
        return 2
    return None


def _artifact_gates(files, root, emit) -> tuple[int, list[str]] | int:
    """The lock-graph and taxonomy diff gates: (findings emitted, names of
    the gates that ran), or 2 on an internal error."""
    n, ran = 0, []
    if not _audited(root):
        return n, ran
    try:
        if lockgraph.lock_pass_needed(files):
            ran.append("lock graph")
            committed = lockgraph.load_graph(root / lockgraph.LOCK_GRAPH_NAME)
            if committed is None:
                found = [Finding(
                    "R12", lockgraph.LOCK_GRAPH_NAME, 0, "missing-lock-graph",
                    "no committed lock-order graph; run `python -m "
                    "esac_tpu_torch.lint --write-lock-graph`, review the "
                    "edges, and commit the file")]
            else:
                found, stale = lockgraph.diff_graph(committed,
                                                    lockgraph.build_graph(root))
                for note in stale:
                    _note(f"torch-lint: {note}")
            for f in found:
                emit(f)
            n += len(found)
        if faultflow.fault_pass_needed(files):
            ran.append("fault taxonomy")
            current = faultflow.build_taxonomy(root)
            committed = faultflow.load_taxonomy(root / faultflow.FAULT_TAXONOMY_NAME)
            if committed is None:
                found = [] if not (current["errors"] or current["edges"]) else [Finding(
                    "R16", faultflow.FAULT_TAXONOMY_NAME, 0, "missing-fault-taxonomy",
                    "no committed fault taxonomy; run `python -m "
                    "esac_tpu_torch.lint --write-taxonomy`, review the error "
                    "catalog and raise->outcome edges, and commit the file")]
            else:
                found, stale = faultflow.diff_taxonomy(committed, current)
                for note in stale:
                    _note(f"torch-lint: {note}")
            for f in found:
                emit(f)
            n += len(found)
    except Exception as e:
        _note(f"torch-lint: internal error in an artifact gate: {e!r}")
        return 2
    return n, ran


def _graph_needed(files) -> bool:
    return files is None or any(
        f.startswith("esac_tpu_torch/") and f.endswith(".py") for f in files)


def _graph_gates(root, emit) -> int | None:
    """The graph layer: J1-J3 over the registry's traces and the ledger
    diff (J4, J5).  -> the count of findings emitted, or None on an
    internal error; notes go to stderr."""
    from esac_tpu_torch.lint import graph_audit, ledger

    try:
        traced = graph_audit.trace_entries()
        found, stale = graph_audit.run_audit(traced)
        current = ledger.build_ledger(traced)
        committed = ledger.load_ledger(root / ledger.LEDGER_NAME)
        if committed is None:
            found.append(Finding(
                "J4", ledger.LEDGER_NAME, 0, "missing-ledger",
                "no committed graph ledger; run `python -m esac_tpu_torch.lint "
                "--write-ledger`, review the numbers, and commit the file"))
        else:
            more, drift = ledger.diff_ledger(committed, current)
            found += more
            stale += drift
    except Exception as e:
        _note(f"torch-lint: internal error in the graph layer: {e!r}")
        return None
    for note in stale:
        _note(f"torch-lint: {note}")
    for f in found:
        emit(f)
    return len(found)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m esac_tpu_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: full tree)")
    parser.add_argument("--changed", action="store_true",
                        help="lint only git-modified/untracked files")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="finding output format (json: one object per "
                             "line, stable ids, notes on stderr)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detect)")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline path (default: <root>/{BASELINE_NAME})")
    parser.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from current findings")
    parser.add_argument("--write-lock-graph", action="store_true",
                        help="regenerate lock_graph.json from the current "
                             "fleet lock analysis")
    parser.add_argument("--write-taxonomy", action="store_true",
                        help="regenerate fault_taxonomy.json from the "
                             "current fault-flow analysis")
    parser.add_argument("--no-graph", action="store_true",
                        help="skip the graph layer (registry traces, J1-J5)")
    parser.add_argument("--write-ledger", action="store_true",
                        help="regenerate graph_ledger.json from the current "
                             "registry traces")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, (summary, rationale) in RULES.items():
            print(f"{rule}: {summary}\n    ({rationale})")
        return 0

    root = pathlib.Path(args.root).resolve() if args.root else find_repo_root()
    baseline_path = (
        pathlib.Path(args.baseline) if args.baseline else root / BASELINE_NAME
    )
    wrote = _write(args, root)
    if wrote is not None:
        return wrote

    seen_ids: dict[str, int] = {}

    def emit(f: Finding) -> None:
        if args.format == "json":
            ordinal = seen_ids.get(f.id, 0)
            seen_ids[f.id] = ordinal + 1
            print(f.to_json(ordinal))
        else:
            print(f.format())

    # Everything up to the verdict is internal: a crash here exits 2,
    # never 1.
    try:
        files: list[str] | None = None
        if args.changed:
            files = _changed_files(root)
            if not files:
                _note("torch-lint: no changed files")
                return 0
        elif args.paths:
            files = _expand_paths(root, args.paths)

        with record_usage() as used_suppressions:
            findings = run_layer1(root, files=files)

        if args.write_baseline:
            if files is not None:
                _note("torch-lint: --write-baseline requires a full-tree run "
                      "(drop --changed / PATHS)")
                return 2
            Baseline.from_findings(findings).write(baseline_path)
            _note(f"torch-lint: wrote {len(findings)} entries to {baseline_path}")
            return 0

        findings, stale = Baseline.load(baseline_path).apply(findings)
    except Exception as e:
        _note(f"torch-lint: internal error in the static rules: {e!r}")
        return 2
    # Only a full run sees every finding a directive or a baseline entry
    # could mask, so only a full run may call one stale.
    if files is None:
        for e in stale:
            _note(f"torch-lint: stale baseline entry ({e.rule} {e.path}): "
                  f"expired or no longer matches -- remove it from "
                  f"{baseline_path.name}")
        try:
            for note in stale_findings(root, used_suppressions):
                _note(f"torch-lint: {note}")
            for note in stale_r11_waivers(root):
                _note(f"torch-lint: {note}")
        except Exception as e:  # notes only: never block the verdict
            _note(f"torch-lint: suppression sweep failed: {e!r}")

    for f in findings:
        emit(f)
    gated = _artifact_gates(files, root, emit)
    if gated == 2:
        return 2
    n_gate, ran = gated
    if not args.no_graph and _graph_needed(files) and _audited(root) \
            and (root / "esac_tpu_torch/lint/registry.py").exists():
        n_graph = _graph_gates(root, emit)
        if n_graph is None:
            return 2
        n_gate += n_graph
        ran.append("graph audit + ledger")

    n = len(findings) + n_gate
    scope = "changed files" if args.changed else ("paths" if args.paths else "tree")
    summary = (f"torch-lint: {n} finding(s) over {scope}"
               + (f" (incl. {', '.join(ran)})" if ran else ""))
    if args.format == "json":
        _note(summary)
    else:
        print(summary)
    return 1 if n else 0


def stale_findings(root: pathlib.Path, used) -> list[str]:
    """Notes for every inline directive of the tree that masked nothing in
    a full run (the lint's own package excluded: its text documents)."""
    declared = {d for d in declared_suppressions(root)
                if not d[0].startswith(("tests/", LINT_PACKAGE))}
    return stale_suppressions(declared, used)
