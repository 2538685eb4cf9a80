"""Static layer, R12/R13: whole-fleet lock analysis (counterpart of
``esac_tpu/lint/lockgraph.py``).

R10 (:mod:`esac_tpu_torch.lint.concurrency`) asks, one class at a time,
whether guarded state is touched unlocked.  This module asks the two
questions R10 cannot: can the fleet's locks deadlock (R12), and does
anything block or take unbounded time while holding one (R13)?

**The model.**  Pure AST over the port's ``serve/``, ``registry/``,
``obs/``, ``fleet/`` and ``retrieval/`` (the JAX package's scope by
directory).  The port's other lock sites stay outside it, as neither can
take part in an order with the fleet's locks: the lock of
``parallel/multihost.lead`` serializes rank 0's broadcast and call of the
sharded serve function, which takes no fleet lock, and ``_build.py``'s
guards the nvcc / g++ build and the table of loaded libraries at first
use.

- **Lock nodes**: one node per ``(class, lock attribute)``, where lock
  attributes are ``threading.Lock`` / ``RLock`` assignments in
  ``__init__``; ``threading.Condition`` aliases collapse onto the lock
  they wrap (a bare ``Condition()`` owns its lock).  Nodes are per class,
  instance-collapsed.
- **May-held propagation**: for every method, helper, closure and
  module-level function, the set of locks that may be held when it runs:
  lexical ``with self.<lock>:`` state unioned, through a fixpoint, into
  every resolvable callee (``self._helper()``, typed-attribute calls,
  annotation-resolved chains, cross-module function calls).  Types come
  from ``__init__`` constructor calls, parameter / return annotations and
  known-class constructors; unresolvable calls under-approximate.
  Closures start over as held-nothing (they run later).
- **R12 -- lock-order graph**: acquiring lock B while possibly holding A
  is the edge A -> B.  The canonical edge set is committed as
  ``esac_tpu_torch/lint/lock_graph.json``; a cycle, a re-acquisition of a
  non-reentrant lock, or an edge missing from the committed file fails
  (regenerate with ``--write-lock-graph`` and review; an edge that
  disappeared is reported stale).
- **R13 -- blocking under a lock**: ``Event.wait`` / ``Condition.wait``,
  ``Future.result``, ``.join``, ``time.sleep``, file IO and checkpoint
  loads, and the device syncs (``torch.cuda.synchronize``,
  ``Event.synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``) reached with any lock held.  The coalescing wait --
  ``Condition.wait`` on a condition aliasing the only held lock, which
  releases it -- is allowed.

The runtime side is :mod:`esac_tpu_torch.lint.witness`: a wrapper around
the fleet's lock objects that records the edges actually taken and holds
them to the committed order.

Pure stdlib: no imports of the checked modules.
"""

from __future__ import annotations

import ast
import json
import pathlib

from esac_tpu_torch.lint.ast_rules import _alias_map, _dotted, iter_python_files
from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.suppress import (
    is_suppressed,
    note_usage,
    parse_suppressions,
    record_usage,
)

LOCK_GRAPH_NAME = "esac_tpu_torch/lint/lock_graph.json"

# The fleet scope the graph covers...
FLEET_PREFIXES = tuple(f"esac_tpu_torch/{d}/" for d in
                       ("serve", "registry", "obs", "fleet", "retrieval"))
# ...and what triggers the pass in --changed mode (the analysis itself
# lives in esac_tpu_torch/lint/, so editing it re-runs the gate).
PASS_PREFIXES = FLEET_PREFIXES + ("esac_tpu_torch/lint/",)


def lock_pass_needed(files) -> bool:
    """Mirror of cli._audit_needed for the lock-graph pass: full runs
    always analyze; scoped runs only when a fleet or lint file changed."""
    if files is None:
        return True
    return any(
        f.startswith(PASS_PREFIXES) and f.endswith(".py") for f in files
    )


# --------------------------------------------------------------------------
# the blocking catalog (R13)

# Dotted-name calls that block or sync regardless of receiver type.
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep parks the thread",
    "torch.cuda.synchronize": "a device sync waits for in-flight work",
}
# Tensor / Event methods that sync with the device.
_SYNC_ATTRS = {
    "synchronize": "Event / stream synchronize waits for in-flight work",
    "item": ".item() reads a device value back (a device sync)",
    "cpu": ".cpu() copies a device tensor back (a device sync)",
    "tolist": ".tolist() reads a device tensor back (a device sync)",
    "numpy": ".numpy() reads a tensor's values back (a device sync)",
}
# Bare-name calls (registry/checkpoint IO — the 29ms..seconds cold-load
# class) and plain file IO.
_BLOCKING_NAMES = {
    "load_checkpoint": "checkpoint read (the cold-load IO path)",
    "save_checkpoint": "checkpoint write",
    "load_scene_params": "scene weight load (retrying checkpoint IO)",
    "open": "file IO",
}
_IO_ATTRS = {"read_text", "write_text", "read_bytes", "write_bytes"}
# Receivers whose .join is a path join, not a thread join.
_JOIN_EXEMPT_PREFIXES = ("os.", "posixpath.", "ntpath.", "str.")

_GENERIC_CONTAINERS = {
    "list", "List", "dict", "Dict", "tuple", "Tuple", "set", "Set",
    "frozenset", "deque", "Sequence", "Iterable", "Iterator", "Mapping",
}


# --------------------------------------------------------------------------
# per-class facts

def _self_attr(node) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _Class:
    def __init__(self, rel: str, node: ast.ClassDef, aliases: dict):
        self.rel = rel
        self.name = node.name
        self.node = node
        self.aliases = aliases
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body if isinstance(n, ast.FunctionDef)
        }
        # lock attr -> root lock attr (Condition aliases collapse);
        # root attr -> kind ("Lock" | "RLock" | "Condition").
        self.lock_roots: dict[str, str] = {}
        self.lock_kinds: dict[str, str] = {}
        self._collect_locks()
        self.attr_types: dict[str, str] = {}       # filled by _Analysis
        self.method_returns: dict[str, str] = {}   # filled by _Analysis

    def _collect_locks(self) -> None:
        init = self.methods.get("__init__")
        if init is None:
            return
        for node in ast.walk(init):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            attr = _self_attr(node.targets[0])
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            dotted = _dotted(node.value.func, self.aliases) or ""
            base = dotted.rpartition(".")[2]
            if dotted in ("threading.Lock", "threading.RLock") or \
                    (dotted == base and base in ("Lock", "RLock")):
                self.lock_roots[attr] = attr
                self.lock_kinds[attr] = base
            elif dotted == "threading.Condition" or \
                    (dotted == base and base == "Condition"):
                arg = node.value.args[0] if node.value.args else None
                wrapped = _self_attr(arg) if arg is not None else None
                if wrapped is not None and wrapped in self.lock_roots:
                    # Condition(self.X) IS lock X: one node, two names.
                    self.lock_roots[attr] = self.lock_roots[wrapped]
                else:
                    self.lock_roots[attr] = attr
                    self.lock_kinds[attr] = "Condition"

    def node_id(self, attr: str) -> str:
        return f"{self.name}.{self.lock_roots[attr]}"


def _ann_class(ann, known: dict) -> str | None:
    """Class name named by an annotation, if exactly one known class.

    ``X``, ``"X"``, ``X | None``, ``Optional[X]`` resolve; container
    annotations (``list[X]``…) deliberately do NOT — a list of X is not
    an X, and typing it as one would fabricate call edges."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.strip().strip("'\"")
        return name if name in known else None
    if isinstance(ann, ast.Name):
        return ann.id if ann.id in known else None
    if isinstance(ann, ast.Attribute):
        return ann.attr if ann.attr in known else None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        hits = {c for c in (_ann_class(ann.left, known),
                            _ann_class(ann.right, known)) if c}
        return hits.pop() if len(hits) == 1 else None
    if isinstance(ann, ast.Subscript):
        base = ann.value
        base_name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else None
        )
        if base_name in _GENERIC_CONTAINERS:
            return None
        if base_name in ("Optional", "Union", "Annotated"):
            sl = ann.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            hits = {c for c in (_ann_class(e, known) for e in elts) if c}
            return hits.pop() if len(hits) == 1 else None
        return None
    return None


# --------------------------------------------------------------------------
# the analysis

class _CallableInfo:
    __slots__ = ("key", "rel", "cls", "label", "acquisitions", "blocking",
                 "calls")

    def __init__(self, key, rel, cls, label):
        self.key = key
        self.rel = rel
        self.cls = cls          # _Class or None (module functions)
        self.label = label      # "Class.method" / "module:fn" for provenance
        self.acquisitions = []  # (node_id, frozenset(held_lex), lineno)
        self.blocking = []      # (kind, detail, release_node, held_lex, lineno)
        self.calls = []         # (callee_key, frozenset(held_lex))


class _Analysis:
    def __init__(self, root: pathlib.Path, prefixes=FLEET_PREFIXES):
        self.root = root
        self.prefixes = prefixes
        # Every class in scope, for WALKING (acquisitions/blocking are
        # always analyzed, even under a name collision)...
        self.class_list: list[_Class] = []
        # ...vs the name->class map for TYPED dispatch, where ambiguous
        # names must drop out (sound: unresolved calls under-approximate).
        self.classes: dict[str, _Class] = {}
        self.mod_functions: dict[str, dict[str, ast.FunctionDef]] = {}
        self.mod_of_rel: dict[str, str] = {}
        self.files: dict[str, tuple] = {}  # rel -> (tree, aliases, lines,
        #                                            per_line, per_file)
        self.callables: dict[tuple, _CallableInfo] = {}
        self.entry: dict[tuple, frozenset] = {}
        self.edges: dict[tuple[str, str], set[str]] = {}
        self.findings: list[Finding] = []
        self._load()
        self._type_pass()
        self._walk_all()
        self._fixpoint()
        self._emit()

    # ---- pass 0: parse the fleet scope ----

    def _load(self) -> None:
        for rel in iter_python_files(self.root):
            if not rel.startswith(self.prefixes):
                continue
            try:
                source = (self.root / rel).read_text()
                tree = ast.parse(source, filename=rel)
            except (SyntaxError, UnicodeDecodeError):
                continue  # R0 comes from the main python pass
            aliases = _alias_map(tree)
            per_line, per_file = parse_suppressions(source)
            self.files[rel] = (tree, aliases, source.splitlines(),
                               per_line, per_file)
            dotted_mod = rel[:-3].replace("/", ".")
            self.mod_of_rel[rel] = dotted_mod
            fns = {}
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    c = _Class(rel, node, aliases)
                    self.class_list.append(c)
                    # Duplicate class names across files make TYPED
                    # dispatch ambiguous — drop the name from the typing
                    # map only; both classes stay fully walked (their
                    # same-id lock nodes merge, which is the node model's
                    # instance-collapse applied to name collisions).
                    if c.name in self.classes:
                        self.classes[c.name] = None  # type: ignore[assignment]
                    else:
                        self.classes[c.name] = c
                elif isinstance(node, ast.FunctionDef):
                    fns[node.name] = node
            self.mod_functions[dotted_mod] = fns
        self.classes = {k: v for k, v in self.classes.items()
                        if v is not None}

    # ---- pass 1: attribute / return types ----

    def _type_pass(self) -> None:
        known = self.classes
        for cls in known.values():
            for name, m in cls.methods.items():
                ret = _ann_class(m.returns, known)
                if ret is not None:
                    cls.method_returns[name] = ret
        for cls in known.values():
            init = cls.methods.get("__init__")
            if init is None:
                continue
            local = self._param_types(init)
            for stmt in init.body:
                for node in ast.walk(stmt):
                    if not (isinstance(node, ast.Assign)
                            and len(node.targets) == 1):
                        continue
                    t = self._expr_type(node.value, cls, local)
                    target = node.targets[0]
                    attr = _self_attr(target)
                    if attr is not None and t is not None:
                        cls.attr_types[attr] = t
                    elif isinstance(target, ast.Name) and t is not None:
                        local[target.id] = t

    def _param_types(self, fn: ast.FunctionDef) -> dict[str, str]:
        out = {}
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = _ann_class(a.annotation, self.classes)
            if t is not None:
                out[a.arg] = t
        return out

    def _expr_type(self, expr, cls: _Class | None,
                   local: dict[str, str]) -> str | None:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and cls is not None:
                return cls.name
            return local.get(expr.id)
        if isinstance(expr, ast.Attribute):
            attr = _self_attr(expr)
            if attr is not None and cls is not None:
                return cls.attr_types.get(attr)
            return None
        if isinstance(expr, ast.IfExp):
            hits = {t for t in (self._expr_type(expr.body, cls, local),
                                self._expr_type(expr.orelse, cls, local))
                    if t}
            return hits.pop() if len(hits) == 1 else None
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in self.classes:
                return f.id
            aliases = cls.aliases if cls is not None else {}
            dotted = _dotted(f, aliases)
            if dotted is not None:
                base = dotted.rpartition(".")[2]
                if base in self.classes and (dotted == base
                                             or "." in dotted):
                    # Constructor via import alias (dotted resolves to the
                    # class) — but only when it's not a method call on a
                    # typed receiver, which the branch below handles.
                    if not isinstance(f, ast.Attribute) or \
                            self._expr_type(f.value, cls, local) is None:
                        return base
            if isinstance(f, ast.Attribute):
                recv_t = self._expr_type(f.value, cls, local)
                if recv_t is not None:
                    owner = self.classes.get(recv_t)
                    if owner is not None:
                        return owner.method_returns.get(f.attr)
        return None

    # ---- pass 2: walk every callable ----

    def _walk_all(self) -> None:
        for cls in self.class_list:
            # Key on (rel, name) so a name collision cannot alias two
            # classes' callables onto one entry-set.
            for m in cls.methods.values():
                self._walk_callable(("C", cls.rel, cls.name, m.name),
                                    cls.rel, cls, m)
        for rel, (tree, _aliases, _lines, _pl, _pf) in self.files.items():
            mod = self.mod_of_rel[rel]
            for node in tree.body:
                if isinstance(node, ast.FunctionDef):
                    self._walk_callable(("F", mod, node.name), rel, None,
                                        node)

    def _walk_callable(self, key, rel, cls, fn) -> None:
        label = (f"{cls.name}.{fn.name}" if cls is not None
                 else f"{self.mod_of_rel[rel]}.{fn.name}")
        info = _CallableInfo(key, rel, cls, label)
        self.callables[key] = info
        local = self._param_types(fn)
        nested: list = []

        def lock_root_of(expr) -> str | None:
            attr = _self_attr(expr)
            if attr is not None and cls is not None and \
                    attr in cls.lock_roots:
                return attr
            return None

        def visit(node, held: frozenset) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    root = lock_root_of(item.context_expr)
                    if root is not None:
                        nid = cls.node_id(root)
                        info.acquisitions.append(
                            (nid, held, item.context_expr.lineno)
                        )
                        acquired.append(nid)
                    else:
                        visit(item.context_expr, held)
                h2 = held | frozenset(acquired)
                for child in node.body:
                    visit(child, h2)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                # Closures run later, possibly without the lock: analyzed
                # as their own held-∅ callables (R10 convention).
                nested.append(node)
                return
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = self._expr_type(node.value, cls, local)
                if t is not None:
                    local[node.targets[0].id] = t
            if isinstance(node, ast.Call):
                self._classify_call(info, node, held, cls, local)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, frozenset())
        for i, sub in enumerate(nested):
            name = getattr(sub, "name", f"<lambda:{sub.lineno}>")
            self._walk_callable(key + (f"{name}@{sub.lineno}",), rel, cls,
                                _as_fn(sub))

    def _classify_call(self, info, call: ast.Call, held: frozenset,
                       cls, local) -> None:
        f = call.func
        aliases = self.files[info.rel][1]
        dotted = _dotted(f, aliases)

        # ---- blocking catalog ----
        if dotted in _BLOCKING_DOTTED:
            info.blocking.append(
                ("blocking", _BLOCKING_DOTTED[dotted], None, held,
                 call.lineno)
            )
        elif isinstance(f, ast.Name) and f.id in _BLOCKING_NAMES:
            info.blocking.append(
                ("blocking", _BLOCKING_NAMES[f.id], None, held, call.lineno)
            )
        elif isinstance(f, ast.Attribute):
            if f.attr == "wait":
                root = None
                attr = _self_attr(f.value)
                if attr is not None and cls is not None and \
                        attr in cls.lock_roots:
                    root = cls.node_id(attr)
                info.blocking.append((
                    "wait",
                    "Condition.wait releases only its own lock"
                    if root is not None else
                    "Event/Condition wait can block unboundedly",
                    root, held, call.lineno,
                ))
            elif f.attr == "join" and not isinstance(f.value, ast.Constant):
                if not (dotted or "").startswith(_JOIN_EXEMPT_PREFIXES):
                    info.blocking.append(
                        ("blocking", "join blocks until the target "
                         "finishes", None, held, call.lineno)
                    )
            elif f.attr == "result" and isinstance(
                    f.value, (ast.Name, ast.Attribute)):
                info.blocking.append(
                    ("blocking", "Future.result blocks until the future "
                     "resolves", None, held, call.lineno)
                )
            elif f.attr in _SYNC_ATTRS and dotted != "torch.cuda.synchronize":
                info.blocking.append(
                    ("blocking", _SYNC_ATTRS[f.attr], None, held, call.lineno)
                )
            elif f.attr in _IO_ATTRS:
                info.blocking.append(
                    ("blocking", "file IO", None, held, call.lineno)
                )
            elif f.attr in _BLOCKING_NAMES and dotted is None:
                info.blocking.append(
                    ("blocking", _BLOCKING_NAMES[f.attr], None, held,
                     call.lineno)
                )

        # ---- propagation edges ----
        callee = self._resolve_callee(call, info, cls, local)
        if callee is not None:
            info.calls.append((callee, held))

    def _resolve_callee(self, call, info, cls, local):
        f = call.func
        if isinstance(f, ast.Attribute):
            recv_t = self._expr_type(f.value, cls, local)
            if recv_t is not None:
                owner = self.classes.get(recv_t)
                if owner is not None and f.attr in owner.methods:
                    return ("C", owner.rel, recv_t, f.attr)
            dotted = _dotted(f, self.files[info.rel][1])
            if dotted is not None:
                mod, _, name = dotted.rpartition(".")
                fns = self.mod_functions.get(mod)
                if fns is not None and name in fns:
                    return ("F", mod, name)
        elif isinstance(f, ast.Name):
            mod = self.mod_of_rel[info.rel]
            if f.id in self.mod_functions.get(mod, {}):
                return ("F", mod, f.id)
            dotted = _dotted(f, self.files[info.rel][1])
            if dotted is not None and "." in dotted:
                m, _, name = dotted.rpartition(".")
                fns = self.mod_functions.get(m)
                if fns is not None and name in fns:
                    return ("F", m, name)
        return None

    # ---- pass 3: may-held fixpoint ----

    def _fixpoint(self) -> None:
        self.entry = {key: frozenset() for key in self.callables}
        changed = True
        while changed:
            changed = False
            for key, info in self.callables.items():
                base = self.entry[key]
                for callee, held_lex in info.calls:
                    if callee not in self.entry:
                        continue
                    target = base | held_lex
                    if not target <= self.entry[callee]:
                        self.entry[callee] = self.entry[callee] | target
                        changed = True

    # ---- pass 4: edges + findings ----

    def _emit(self) -> None:
        for key, info in self.callables.items():
            base = self.entry[key]
            _tree, _al, lines, per_line, per_file = self.files[info.rel]
            for nid, held_lex, lineno in info.acquisitions:
                held = base | held_lex
                for h in sorted(held):
                    if h == nid:
                        kind = self._node_kind(nid)
                        if kind == "RLock":
                            continue  # reentrant by design
                        f = Finding(
                            "R12", info.rel, lineno, _line(lines, lineno),
                            f"{info.label} re-acquires non-reentrant lock "
                            f"{nid} while it may already be held (callers "
                            "enter with the lock taken): self-deadlock — "
                            "split a '(lock held)' helper or make the "
                            "caller drop the lock first",
                        )
                        if not is_suppressed("R12", lineno, per_line,
                                             per_file, path=info.rel):
                            self.findings.append(f)
                    else:
                        self.edges.setdefault((h, nid), set()).add(
                            info.label
                        )
            for kind, what, release, held_lex, lineno in info.blocking:
                held = base | held_lex
                if kind == "wait" and release is not None:
                    # The coalescing idiom: waiting on a Condition aliasing
                    # a held lock RELEASES it — only OTHER held locks block.
                    held = held - {release}
                if not held:
                    continue
                f = Finding(
                    "R13", info.rel, lineno, _line(lines, lineno),
                    f"{info.label} can block while holding "
                    f"{', '.join(sorted(held))}: {what} — every thread "
                    "needing the lock stalls behind it (the wedge class "
                    "this fleet exists to bound); move the call outside "
                    "the critical section (snapshot under the lock, block "
                    "outside — the _drain_probes/cache-load pattern)",
                )
                if not is_suppressed("R13", lineno, per_line, per_file,
                                     path=info.rel):
                    self.findings.append(f)
        self.findings += self._cycle_findings()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))

    def _node_kind(self, nid: str) -> str:
        cls_name, _, attr = nid.partition(".")
        kinds = {
            c.lock_kinds.get(attr, "Lock")
            for c in self.class_list
            if c.name == cls_name and attr in c.lock_kinds
        }
        # Name-collided classes share a node id; a mixed-kind collision
        # is treated as non-reentrant (the conservative verdict).
        return kinds.pop() if len(kinds) == 1 else "Lock"

    def _cycle_findings(self) -> list[Finding]:
        adj: dict[str, list[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, []).append(dst)
        for dsts in adj.values():
            dsts.sort()
        seen: set[str] = set()
        cycles: list[tuple[str, ...]] = []

        def dfs(node, stack, on_stack):
            seen.add(node)
            on_stack[node] = len(stack)
            stack.append(node)
            for nxt in adj.get(node, ()):
                if nxt in on_stack:
                    cyc = tuple(stack[on_stack[nxt]:])
                    # Canonical rotation so the finding id is stable.
                    i = cyc.index(min(cyc))
                    cycles.append(cyc[i:] + cyc[:i])
                elif nxt not in seen:
                    dfs(nxt, stack, on_stack)
            stack.pop()
            del on_stack[node]

        for node in sorted(adj):
            if node not in seen:
                dfs(node, [], {})
        out = []
        for cyc in sorted(set(cycles)):
            sig = "->".join(cyc + (cyc[0],))
            out.append(Finding(
                "R12", LOCK_GRAPH_NAME, 0, f"cycle:{sig}",
                f"lock-order cycle {sig}: two threads taking these locks "
                "in opposite orders deadlock the fleet — break the cycle "
                "(move one acquisition outside the other's critical "
                "section, or merge the domains)",
            ))
        return out

    # ---- the committed artifact ----

    def graph(self) -> dict:
        nodes: dict[str, dict] = {}
        for cls in self.class_list:
            for attr, root in sorted(cls.lock_roots.items()):
                nid = f"{cls.name}.{root}"
                rec = nodes.setdefault(nid, {
                    "file": cls.rel,
                    "kind": cls.lock_kinds.get(root, "Lock"),
                    "aliases": [],
                })
                if attr != root and attr not in rec["aliases"]:
                    rec["aliases"].append(attr)
        for rec in nodes.values():
            rec["aliases"].sort()
        edges = [
            {"src": src, "dst": dst, "via": sorted(via)}
            for (src, dst), via in sorted(self.edges.items())
        ]
        return {"nodes": {k: nodes[k] for k in sorted(nodes)},
                "edges": edges}


def _as_fn(node):
    """Normalize a Lambda into a FunctionDef-shaped object for the walker."""
    if isinstance(node, ast.Lambda):
        fn = ast.FunctionDef(
            name=f"<lambda:{node.lineno}>", args=node.args,
            body=[ast.Expr(value=node.body)], decorator_list=[],
            returns=None,
        )
        ast.copy_location(fn, node)
        ast.fix_missing_locations(fn)
        return fn
    return node


def _line(lines, lineno):
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


# --------------------------------------------------------------------------
# public API

# One full lint run needs the analysis twice (run_layer1's R12/R13 pass +
# the CLI's committed-graph diff); memoize on the scope files' identity so
# the fixpoint runs once per tree state.  Keyed on (path, mtime_ns, size)
# per scope file — fixture trees that rewrite a file re-analyze.
_MEMO: dict = {}
_MEMO_CAP = 8


def analyze(root, prefixes=FLEET_PREFIXES) -> _Analysis:
    root = pathlib.Path(root)
    try:
        fingerprint = tuple(
            (rel, (root / rel).stat().st_mtime_ns, (root / rel).stat().st_size)
            for rel in iter_python_files(root)
            if rel.startswith(prefixes)
        )
    except OSError:
        return _Analysis(root, prefixes)  # racing tree: skip the memo
    key = (str(root.resolve()), prefixes, fingerprint)
    a = _MEMO.get(key)
    if a is None:
        with record_usage() as hits:
            a = _Analysis(root, prefixes)
        a.suppression_hits = frozenset(hits)
        if len(_MEMO) >= _MEMO_CAP:
            _MEMO.pop(next(iter(_MEMO)))
        _MEMO[key] = a
    # A memoized analysis replays the directives it used into the caller's
    # stale-suppression sweep.
    note_usage(a.suppression_hits)
    return a


def build_graph(root, prefixes=FLEET_PREFIXES) -> dict:
    return analyze(root, prefixes).graph()


def run_lock_rules(root, files=None, prefixes=FLEET_PREFIXES):
    """R12 (self-deadlock + cycles) and R13 findings over the fleet scope
    of ``root``.  The whole scope is always analyzed — lock order is a
    fleet-global property — but the pass is skipped entirely when a
    scoped run touched no fleet/lint file (``--changed`` fast mode).
    The committed-graph DIFF is the CLI's job (ledger pattern)."""
    if not lock_pass_needed(files):
        return []
    return analyze(root, prefixes).findings


def write_graph(path: pathlib.Path, graph: dict) -> None:
    data = {
        "comment": "The port's lock-order graph.  Nodes "
                   "are (class, lock attribute) — Condition aliases "
                   "collapse onto the lock they wrap — and each edge "
                   "src->dst means dst may be acquired while src is held "
                   "(via: the acquiring method).  The edge set is the "
                   "canonical acquisition partial order: a cycle or an "
                   "uncommitted new edge fails tier-1; regenerate with "
                   "`python -m esac_tpu_torch.lint --write-lock-graph` and "
                   "review the diff.  The runtime witness "
                   "(esac_tpu_torch/lint/witness.py) asserts observed "
                   "edges are a subgraph of this order.",
        **graph,
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def load_graph(path: pathlib.Path) -> dict | None:
    if not path.exists():
        return None
    data = json.loads(path.read_text())
    return {"nodes": data.get("nodes", {}), "edges": data.get("edges", [])}


def _edge_map(graph: dict) -> dict[tuple[str, str], list[str]]:
    return {
        (e["src"], e["dst"]): list(e.get("via", []))
        for e in graph.get("edges", [])
    }


def diff_graph(committed: dict, current: dict):
    """-> (R12 findings, stale notes), J4-style: a CURRENT edge the
    committed order does not sanction fails; committed edges/nodes that
    drifted away are stale (regenerate + review)."""
    findings: list[Finding] = []
    stale: list[str] = []
    want = _edge_map(committed)
    have = _edge_map(current)
    for (src, dst), via in sorted(have.items()):
        old = want.get((src, dst))
        if old is None:
            findings.append(Finding(
                "R12", LOCK_GRAPH_NAME, 0, f"edge:{src}->{dst}",
                f"unreviewed lock-order edge {src} -> {dst} "
                f"(via {', '.join(via)}): not in the committed "
                f"{LOCK_GRAPH_NAME} — if intentional, regenerate with "
                "`python -m esac_tpu_torch.lint --write-lock-graph`, review "
                "the diff (does the new nesting keep the order acyclic "
                "fleet-wide?), and commit",
            ))
        elif sorted(old) != sorted(via):
            stale.append(
                f"lock-graph edge {src} -> {dst} changed provenance "
                f"({', '.join(old)} -> {', '.join(via)}) — regenerate "
                "with --write-lock-graph and review the diff"
            )
    for (src, dst) in sorted(set(want) - set(have)):
        stale.append(
            f"committed lock-graph edge {src} -> {dst} is no longer "
            "taken by any code path — regenerate with --write-lock-graph"
        )
    want_nodes = set(committed.get("nodes", {}))
    have_nodes = set(current.get("nodes", {}))
    for n in sorted(have_nodes - want_nodes):
        stale.append(
            f"lock {n} is new and not in the committed graph — "
            "regenerate with --write-lock-graph and review"
        )
    for n in sorted(want_nodes - have_nodes):
        stale.append(
            f"committed lock-graph node {n} no longer exists — "
            "regenerate with --write-lock-graph"
        )
    return findings, stale


def transitive_closure(edges) -> set[tuple[str, str]]:
    """Closure of an edge iterable ((src, dst) pairs or edge dicts) —
    the PARTIAL-ORDER membership test the runtime witness uses: an
    observed A->C is sanctioned when the committed order says A before
    C, directly or through intermediates."""
    pairs = set()
    for e in edges:
        if isinstance(e, dict):
            pairs.add((e["src"], e["dst"]))
        else:
            pairs.add((e[0], e[1]))
    changed = True
    while changed:
        changed = False
        for (a, b) in list(pairs):
            for (c, d) in list(pairs):
                if b == c and (a, d) not in pairs and a != d:
                    pairs.add((a, d))
                    changed = True
    return pairs
