"""Graph layer: audit the aten graphs of the registered entry points
(counterpart of ``esac_tpu/lint/jaxpr_audit.py``).

Each :mod:`~.registry` entry is run on the CPU at tiny shapes, twice, on
two input contents of the same shapes, under a dispatch-mode recorder
(:func:`record_graph`) that writes every aten op -- the backward included
-- into a ``torch.fx`` graph, the graph ``make_fx`` records in real mode
at a thirtieth of its cost.  The graphs are audited for:

- **J1** -- disallowed ops: the iterative linalg of R3
  (``linalg_svd``, ``linalg_solve``, ``linalg_inv``, ``linalg_eig*``,
  ``linalg_lstsq``, ``linalg_lu*``, ``linalg_cholesky*``, ...), and the
  data-dependent ones: ``nonzero``, ``masked_select``, ``unique``,
  boolean-mask indexing and ``_local_scalar_dense`` (``.item()``).
- **J2** -- a non-static program: the two traces must issue the same ops
  in the same order with the same output shapes and dtypes; a
  data-dependent shape or a Python branch on data shows as a difference.
- **J3** -- the precision contract in ``pinned`` entries' forward
  programs: no mm family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``matmul``, ``dot``, ``mv``, ``einsum``, ``linear``), no ``sum`` /
  ``mean`` over a reduced extent above ``GROUP`` (32, the
  ``utils/precision.fixed_sum`` group), and no half-precision value.  A
  gradient entry's backward (after ``registry.BACKWARD_MARK``) keeps no
  batch contract and is the J5 census's (:mod:`~.ledger`).

A finding an entry has on purpose is listed in its ``allow`` with the
reason; an allowance that matches nothing is reported stale.  Tracing
runs the entry on the CPU and never touches a device.
"""

from __future__ import annotations

import types

from esac_tpu_torch.lint.findings import Finding

# The most terms one torch.sum may add in a pinned forward
# (esac_tpu_torch/utils/precision.GROUP).
GROUP = 32

_LINALG = {
    "linalg_svd", "_linalg_svd", "svd", "linalg_solve", "_linalg_solve_ex",
    "linalg_solve_ex", "linalg_inv", "linalg_inv_ex", "inverse", "linalg_eig",
    "_linalg_eigh", "linalg_eigh", "linalg_eigvals", "linalg_lstsq",
    "linalg_lu", "linalg_lu_factor_ex", "linalg_lu_solve", "lu_unpack",
    "linalg_cholesky", "linalg_cholesky_ex", "cholesky", "cholesky_solve",
    "cholesky_inverse", "linalg_pinv", "_linalg_det", "linalg_det",
    "_linalg_slogdet", "triangular_solve", "linalg_solve_triangular",
}
_DATA_DEPENDENT = {"nonzero", "masked_select", "_unique2", "unique_dim",
                   "unique_consecutive", "_local_scalar_dense", "nonzero_static"}
_MM_FAMILY = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv", "addmv",
              "einsum", "linear", "vdot", "addbmm"}
_HALF = ("torch.float16", "torch.bfloat16")


def op_name(node) -> str | None:
    """The aten op's short name of a call_function node (``mm``), or None
    for a node that is no aten op."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is None or not str(target).startswith("aten."):
        return None
    return packet.__name__


def aten_nodes(gm) -> list:
    return [n for n in gm.graph.nodes
            if n.op == "call_function" and op_name(n) is not None]


def backward_start(nodes) -> int:
    """Index of the backward marker in ``nodes`` (len(nodes) if none)."""
    from esac_tpu_torch.lint.registry import BACKWARD_MARK

    for i, n in enumerate(nodes):
        if op_name(n) == "_assert_async" and BACKWARD_MARK in n.args[1:]:
            return i
    return len(nodes)


def _vals(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _vals(item)]
    return []


def out_vals(node) -> list:
    """The tensors a node produced (its ``val`` meta)."""
    return _vals(node.meta.get("val"))


def signature(gm) -> list[tuple]:
    """(op, output shapes and dtypes) of every aten node, in order: what
    two traces of one static program share."""
    return [(op_name(n), tuple((tuple(v.shape), str(v.dtype)) for v in out_vals(n)))
            for n in aten_nodes(gm)]


def _reduced_extent(node) -> int:
    """The number of terms one output element of a sum / mean adds."""
    import math

    vals = _vals(node.args[0].meta.get("val")) if hasattr(node.args[0], "meta") else []
    if not vals:
        return 0
    shape = tuple(vals[0].shape)
    dims = node.args[1] if len(node.args) > 1 else None
    if dims is None or dims == [] or dims == ():
        return math.prod(shape)
    dims = [dims] if isinstance(dims, int) else dims
    return math.prod(shape[d] for d in dims) if shape else 1


def _bool_indexed(node) -> bool:
    if op_name(node) not in ("index", "index_put", "_index_put_impl_"):
        return False
    indices = node.args[1] if len(node.args) > 1 else ()
    return any(str(getattr(v, "dtype", "")) == "torch.bool"
               for i in (indices or ()) if hasattr(i, "meta")
               for v in _vals(i.meta.get("val")))


def audit_graphs(entry, gm0, gm1) -> tuple[list[Finding], set]:
    """All J findings of one entry's two traces -> (findings, the allow keys
    that matched).  ``entry.name`` is the finding path."""
    allowed = {(rule, key) for rule, key, _ in entry.allow}
    used: set = set()
    findings: list[Finding] = []
    seen: set = set()

    def add(rule, key, message):
        if (rule, key) in allowed:
            used.add((rule, key))
            return
        if (rule, key) in seen:
            return
        seen.add((rule, key))
        findings.append(Finding(rule, entry.name, 0, key, message))

    nodes = aten_nodes(gm0)
    for n in nodes:
        op = op_name(n)
        if op in _LINALG:
            add("J1", op, f"iterative linalg op '{op}' in a traced entry point: the "
                "library picks its algorithm by batch size and syncs on its error checks")
        elif op in _DATA_DEPENDENT or _bool_indexed(n):
            key = "bool_index" if _bool_indexed(n) else op
            add("J1", key, f"data-dependent op '{key}' in a traced entry point: its "
                "output shape or a host read depends on the values (suppress in "
                "the entry's allow with the reason if it is needed)")
    sig0, sig1 = signature(gm0), signature(gm1)
    if sig0 != sig1:
        i = next((k for k, (a, b) in enumerate(zip(sig0, sig1)) if a != b),
                 min(len(sig0), len(sig1)))
        a = sig0[i] if i < len(sig0) else None
        b = sig1[i] if i < len(sig1) else None
        add("J2", f"op{i}", f"the program depends on the input values: two traces of "
            f"the same shapes first differ at op {i} ({a} vs {b}; {len(sig0)} vs "
            f"{len(sig1)} ops) -- a data-dependent shape or branch")
    if entry.pinned:
        for n in nodes[:backward_start(nodes)]:
            op = op_name(n)
            if op in _MM_FAMILY:
                add("J3", "mm", f"'{op}' in a precision-pinned forward: cuBLAS splits a "
                    "product by the call's size (the frame-bucket contract); use "
                    "utils.precision.hmm")
            elif op in ("sum", "mean") and _reduced_extent(n) > GROUP:
                extent = _reduced_extent(n)
                add("J3", f"sum:{extent}", f"'{op}' over {extent} terms (> {GROUP}) in a "
                    "precision-pinned forward: the split of a long reduction depends "
                    "on the call; use utils.precision.fixed_sum")
            if any(str(v.dtype) in _HALF for v in out_vals(n)):
                add("J3", "half", f"a half-precision value from '{op}' in a "
                    "precision-pinned forward: geometry and scoring stay float32")
    return findings, used


# Traces of this process, by entry name: the audit, the ledger and the
# tests share one tracing pass (tracing dominates the graph layer's cost).
_TRACES: dict = {}


def record_graph(fn, args):
    """Run ``fn(*args)`` on the CPU and record every aten op it dispatches,
    the backward included, as a ``torch.fx.Graph`` (``.graph``): one placeholder
    per input, one ``get_attr`` per tensor made outside the run (a
    constant), one ``call_function`` node per op with its outputs as the
    ``val`` meta -- the graph ``make_fx(fn, tracing_mode="real")``
    records, without its per-node fake-tensor metadata (about 3 s an
    entry on a CPU, against 0.1 s here)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    graph = torch.fx.Graph()
    env: dict = {}    # id(tensor) -> (tensor, node); the tensor is kept alive
    consts: dict = {}

    def bind(t, node):
        env[id(t)] = (t, node)

    def ref(a):
        if isinstance(a, torch.Tensor):
            hit = env.get(id(a))
            if hit is not None and hit[0] is a:
                return hit[1]
            node = graph.get_attr(f"_const{len(consts)}")
            node.meta["val"] = a
            consts[node.target] = a
            bind(a, node)
            return node
        if isinstance(a, (list, tuple)):
            return type(a)(ref(x) for x in a)
        return a

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            node = graph.call_function(func, ref(args), {k: ref(v) for k, v in kwargs.items()})
            node.meta["val"] = out
            for o in _vals(out):
                bind(o, node)
            return out

    for i, a in enumerate(args):
        node = graph.placeholder(f"arg{i}")
        node.meta["val"] = a
        bind(a, node)
    with Recorder():
        out = fn(*args)
    graph.output(ref(out) if isinstance(out, (torch.Tensor, list, tuple)) else None)
    # The graph alone (no GraphModule): collectives carry process-group
    # objects that fx cannot print as code, and nothing here runs it.
    return types.SimpleNamespace(graph=graph, constants=consts)


def trace_entry(entry):
    """(gm0, gm1): the entry recorded on input variants 0 and 1."""
    out = []
    for variant in (0, 1):
        fn, args = entry.build(variant)
        out.append(record_graph(fn, args))
    return tuple(out)


def trace_entries(entries=None) -> list:
    """Every registry entry recorded once per process: ``[(Entry, (gm0,
    gm1))]``, memoized by entry name."""
    from esac_tpu_torch.lint.registry import ENTRIES, single_rank_group

    entries = entries if entries is not None else ENTRIES
    todo = [e for e in entries if e.name not in _TRACES]
    if todo:
        with single_rank_group():
            for e in todo:
                _TRACES[e.name] = trace_entry(e)
    return [(e, _TRACES[e.name]) for e in entries]


def run_audit(traced) -> tuple[list[Finding], list[str]]:
    """J1-J3 over traced entries -> (findings, notes on stale allowances)."""
    findings: list[Finding] = []
    stale: list[str] = []
    for entry, (gm0, gm1) in traced:
        found, used = audit_graphs(entry, gm0, gm1)
        findings += found
        for rule, key, _ in entry.allow:
            if (rule, key) not in used:
                stale.append(f"stale allowance {rule} '{key}' of registry entry "
                             f"'{entry.name}': nothing matches it any more -- prune it")
    return findings, stale
