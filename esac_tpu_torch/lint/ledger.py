"""Graph layer: the resource ledger and the backward hazard census
(counterpart of ``esac_tpu/lint/ledger.py``).

For every registered entry (the graph audit's traces, variant 0) the
ledger records, at the registry's tiny shapes:

- **flops** -- 2·M·N·K for the mm family (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``dot``) and 2·out·(in/groups)·kernel for
  convolutions, one per output element for every other op;
- **peak_intermediate_bytes** -- a liveness scan over the graph: each op's
  output is live from its node to its last user (views alias their base
  and allocate nothing; inputs and constants are not intermediates);
- **ops** -- the census of aten ops, and **top_intermediates**, the
  largest op outputs;
- **grad_hazards** (J5) -- for gradient entries, the domain-edge ops of the
  backward (after ``registry.BACKWARD_MARK``: ``div``, ``reciprocal``,
  ``rsqrt``, ``pow``, ``log``, ``acos``, ``asin``, ``atan2``), each
  counted guarded or unguarded by whether an eps-add, a constant clamp or
  floor, a ``where`` select or ``exp`` dominates the vulnerable operand
  (the producer chain is followed through views, copies, negation, abs,
  sqrt and products of guarded values).

The ledger is committed (``esac_tpu_torch/lint/graph_ledger.json``).
:func:`diff_ledger` is the gate, with the JAX package's tolerances: an
entry without a record, peak bytes or flops grown beyond 1.25x, or a new
op of the mm family in a pinned entry is a J4 finding; a new unguarded
hazard site is a J5 finding; smaller drift is reported stale (regenerate
with ``--write-ledger`` and review the diff).
"""

from __future__ import annotations

import json
import math
import pathlib

from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.graph_audit import (
    _MM_FAMILY,
    aten_nodes,
    backward_start,
    op_name,
    out_vals,
)

LEDGER_NAME = "esac_tpu_torch/lint/graph_ledger.json"

BYTES_TOL = 1.25
FLOPS_TOL = 1.25
_TOP_N = 5

# Ops whose output aliases an input's storage.
_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "select", "slice",
    "unsqueeze", "squeeze", "transpose", "permute", "t", "alias", "detach",
    "as_strided", "view_as_real", "view_as_complex", "diagonal", "unbind",
    "split", "split_with_sizes", "chunk", "narrow", "_conj", "lift_fresh",
    "real", "imag", "unfold", "movedim", "_reshape_alias",
}


def _numel(v) -> int:
    return math.prod(v.shape) if v.shape else 1


def _nbytes(v) -> int:
    return _numel(v) * v.element_size()


def _arg_val(node, i):
    a = node.args[i] if len(node.args) > i else None
    vals = out_vals(a) if hasattr(a, "meta") else []
    return vals[0] if vals else None


def node_flops(node) -> int:
    op = op_name(node)
    outs = out_vals(node)
    out_n = sum(_numel(v) for v in outs)
    if op in ("mm", "bmm", "matmul", "mv", "dot") or op in ("addmm", "baddbmm", "addmv"):
        a = _arg_val(node, 1 if op.startswith("add") or op == "baddbmm" else 0)
        k = a.shape[-1] if a is not None and a.dim() else 1
        return 2 * out_n * k
    if op in ("convolution", "_convolution", "conv2d"):
        w = _arg_val(node, 1)
        if w is not None:
            return 2 * out_n * math.prod(w.shape[1:])
    return out_n


def entry_stats(gm) -> dict:
    """flops, peak intermediate bytes, op census and the largest
    intermediates of one traced graph."""
    nodes = aten_nodes(gm)
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    base: dict = {}
    sizes: dict = {}
    for n in nodes:
        if op_name(n) in _VIEWS and n.args and hasattr(n.args[0], "meta"):
            base[n] = base.get(n.args[0], n.args[0])
        else:
            sizes[n] = sum(_nbytes(v) for v in out_vals(n))
    last_use: dict = {}
    for n in gm.graph.nodes:
        for a in n.all_input_nodes:
            root = base.get(a, a)
            if root in sizes:
                last_use[root] = max(last_use.get(root, 0), order[n])
    frees: dict = {}
    for n, t in last_use.items():
        frees.setdefault(t, []).append(n)
    live = peak = 0
    for n in gm.graph.nodes:
        if n in sizes:
            live += sizes[n]
            peak = max(peak, live)
        for dead in frees.get(order[n], ()):
            live -= sizes[dead]
        if n in sizes and n not in last_use:
            live -= sizes[n]  # never used: freed at once
    census: dict = {}
    for n in nodes:
        op = op_name(n)
        census[op] = census.get(op, 0) + 1
    tops = sorted(((b, op_name(n)) for n, b in sizes.items()), reverse=True)[:_TOP_N]
    return {
        "flops": sum(node_flops(n) for n in nodes),
        "peak_intermediate_bytes": peak,
        "nodes": len(nodes),
        "ops": {k: census[k] for k in sorted(census)},
        "top_intermediates": [{"bytes": b, "op": op} for b, op in tops],
    }


# --------------------------------------------------------------------------
# J5: the backward hazard census

# op -> position of the vulnerable operand (None: any operand).
_HAZARDS = {"div": 1, "reciprocal": 0, "rsqrt": 0, "pow": 0, "log": 0, "log2": 0,
            "log10": 0, "acos": 0, "asin": 0, "atan2": None}
_RANGE = {"acos", "asin"}
_TRANSPARENT = _VIEWS | {"clone", "_to_copy", "contiguous", "neg", "abs", "copy",
                         "expand_copy", "index_select", "gather", "repeat",
                         "amax", "amin", "max", "min", "cat", "stack"}
_DEPTH = 40


def _nonzero_scalar(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and x != 0


def _literal(x):
    return x if isinstance(x, (int, float)) and not isinstance(x, bool) else None


def _dominated(x, depth=_DEPTH) -> bool:
    """Is this operand bounded away from 0 (an eps-add, a constant floor or
    clamp, a where select, exp) along its producer chain?"""
    if _nonzero_scalar(x):
        return True
    if depth <= 0 or not hasattr(x, "op"):
        return False
    if x.op != "call_function":
        return False  # an input or a constant tensor: unknown
    op = op_name(x)
    args = x.args
    if op in ("add", "sub") and len(args) > 1:
        return _nonzero_scalar(args[1]) or _nonzero_scalar(args[0])
    if op in ("clamp", "clamp_min"):
        lo = args[1] if len(args) > 1 else x.kwargs.get("min")
        return lo is not None and _literal(lo) is not None
    if op in ("maximum", "fmax"):
        return any(_nonzero_scalar(a) for a in args)
    if op in ("where", "exp", "scalar_tensor", "full", "ones", "ones_like", "full_like"):
        if op in ("scalar_tensor", "full", "full_like"):
            v = args[-1] if op != "scalar_tensor" else args[0]
            return _nonzero_scalar(v)
        return True
    if op in ("sqrt",):
        return _dominated(args[0], depth - 1)
    if op in ("mul", "div") and len(args) > 1:
        return all(_dominated(a, depth - 1) for a in args[:2])
    if op in _TRANSPARENT and args:
        first = args[0]
        if isinstance(first, (list, tuple)):
            return bool(first) and all(_dominated(a, depth - 1) for a in first)
        return _dominated(first, depth - 1)
    return False


def _range_dominated(x, depth=_DEPTH) -> bool:
    """acos / asin: the operand provably inside [-1, 1]."""
    if depth <= 0 or not hasattr(x, "op") or x.op != "call_function":
        return False
    op = op_name(x)
    if op in ("cos", "sin", "tanh"):
        return True
    if op == "clamp" and len(x.args) >= 3:
        lo, hi = _literal(x.args[1]), _literal(x.args[2])
        return lo is not None and hi is not None and lo >= -1.0 and hi <= 1.0
    if op in _VIEWS | {"clone", "_to_copy"}:
        return _range_dominated(x.args[0], depth - 1)
    return False


def grad_hazard_census(gm) -> dict:
    """{op: {"guarded": n, "unguarded": n}} over the backward of one
    gradient entry's graph."""
    nodes = aten_nodes(gm)
    census: dict = {}
    for n in nodes[backward_start(nodes):]:
        op = op_name(n)
        if op not in _HAZARDS:
            continue
        if op == "pow":
            e = n.args[1] if len(n.args) > 1 else None
            if isinstance(e, (int, float)) and e >= 1 and float(e).is_integer():
                continue  # a total power
        pos = _HAZARDS[op]
        if op in _RANGE:
            guarded = _range_dominated(n.args[0])
        elif pos is None:
            guarded = any(_dominated(a) for a in n.args)
        else:
            guarded = len(n.args) > pos and _dominated(n.args[pos])
        slot = census.setdefault(op, {"guarded": 0, "unguarded": 0})
        slot["guarded" if guarded else "unguarded"] += 1
    return {k: census[k] for k in sorted(census)}


# --------------------------------------------------------------------------
# build / io / diff


def build_ledger(traced) -> dict:
    """``graph_audit.trace_entries()`` output -> {entry: record}."""
    entries = {}
    for entry, (gm, _) in traced:
        stats = {"pinned": entry.pinned, **entry_stats(gm)}
        if entry.grad:
            stats["grad"] = True
            stats["grad_hazards"] = grad_hazard_census(gm)
        entries[entry.name] = stats
    return entries


def write_ledger(path: pathlib.Path, entries: dict) -> None:
    data = {
        "comment": "The port's graph resource ledger: per registered entry at "
                   "the registry's tiny CPU trace shapes, flops, peak "
                   "intermediate bytes (liveness over the aten graph), the op "
                   "census and, for gradient entries, the backward hazard "
                   "census (a new unguarded site fails as J5).  Regenerate "
                   "with `python -m esac_tpu_torch.lint --write-ledger` and "
                   "review the diff.",
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def load_ledger(path: pathlib.Path) -> dict | None:
    if not path.exists():
        return None
    return json.loads(path.read_text()).get("entries", {})


def _mm_count(stats: dict) -> int:
    return sum(n for op, n in stats.get("ops", {}).items() if op in _MM_FAMILY)


def diff_ledger(committed: dict, current: dict) -> tuple[list[Finding], list[str]]:
    """-> (J4 / J5 findings, stale notes)."""
    findings: list[Finding] = []
    stale: list[str] = []
    for name, cur in current.items():
        old = committed.get(name)
        if old is None:
            findings.append(Finding(
                "J4", name, 0, "missing-entry",
                "entry has no committed ledger record; run `python -m "
                "esac_tpu_torch.lint --write-ledger`, review the numbers, and "
                "commit the diff"))
            continue
        drift = old != cur
        for field, tol in (("peak_intermediate_bytes", BYTES_TOL), ("flops", FLOPS_TOL)):
            was, now = old.get(field, 0), cur.get(field, 0)
            if now > was * tol:
                findings.append(Finding(
                    "J4", name, 0, f"{field}:{was}->{now}",
                    f"{field} grew {was} -> {now} (> {tol}x the committed record): "
                    "if intentional, regenerate the ledger and review"))
        if cur.get("pinned") and _mm_count(cur) > _mm_count(old):
            findings.append(Finding(
                "J4", name, 0, f"mm:{_mm_count(old)}->{_mm_count(cur)}",
                "new op of the mm family in a precision-pinned entry's graph: "
                "route the product through utils.precision.hmm"))
        old_h, cur_h = old.get("grad_hazards"), cur.get("grad_hazards")
        if cur_h is not None:
            if old_h is None:
                findings.append(Finding(
                    "J5", name, 0, "missing-hazard-census",
                    "gradient entry has no committed grad_hazards census; "
                    "regenerate with --write-ledger and review"))
            else:
                for op, counts in cur_h.items():
                    was = old_h.get(op, {"guarded": 0, "unguarded": 0})
                    if counts["unguarded"] > was["unguarded"]:
                        findings.append(Finding(
                            "J5", name, 0,
                            f"{op}:unguarded {was['unguarded']}->{counts['unguarded']}",
                            f"new unguarded '{op}' site in this entry's backward: "
                            "no eps-add, constant clamp or select dominates its "
                            "operand -- guard the operand (utils.num, a clamp) "
                            "or, if reviewed safe, regenerate the ledger"))
        if drift:
            stale.append(f"ledger entry '{name}' differs from the committed record "
                         "-- regenerate with --write-ledger and review the diff")
    for name in committed:
        if name not in current:
            stale.append(f"ledger entry '{name}' matches no registry entry -- "
                         "regenerate with --write-ledger")
    return findings, stale
