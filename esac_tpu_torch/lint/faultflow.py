"""Static layer, R16/R17/R18: fault-flow analysis (counterpart of
``esac_tpu/lint/faultflow.py``).

The serving contract -- every way a request or scene can go bad ends in
exactly one typed, accounted outcome -- as a pure-AST pass over the port's
``serve/``, ``registry/``, ``fleet/``, ``obs/`` and ``retrieval/``, a
committed artifact (``esac_tpu_torch/lint/fault_taxonomy.json``), a diff
gate, and a runtime witness
(:class:`esac_tpu_torch.lint.witness.OutcomeWitness`).

**The taxonomy.**  An error class is a member when it derives
(transitively, within fleet scope) from ``ServeError`` (serve/slo.py) or
``ManifestError`` (registry/manifest.py).  Every member carries an
explicit literal ``retryable`` flag and a stable literal ``wire_name``
(a typed error crossing a wire is identified by ``wire_name``, never by a
Python qualname), and wire names are unique fleet-wide.

**R16 -- untyped raise.**  Every raise site in fleet scope that mints an
exception (``raise SomeClass(...)``) must mint a taxonomy member.  The
sanctioned near-miss is constructor-argument validation: a builtin raise
whose innermost enclosing function is ``__init__`` or ``__post_init__``.
Raises that only propagate an existing exception object (bare ``raise``,
``raise e``, ``raise req.error``) are not minting sites.

**R17 -- exception swallowing.**  A broad handler (bare ``except``,
``except Exception``, ``except BaseException``, or a tuple holding one)
must dispose of the fault, matched structurally: a ``raise``; an
augmented assignment (a counter); a store into non-local state (an
attribute or subscript assignment); or a call into the resolve / record
surface (``.set()``, ``.inc`` / ``.observe`` / ``.add`` / ``.append``,
or any ``_finish*`` / ``_record*`` / ``_abandon`` / ``_on_worker*`` /
``_note*`` method).  ``except Exception: pass`` is the flagged shape.

**R18 -- thread / future lifecycle.**  (1) every ``threading.Thread(...)``
in fleet scope is created ``daemon=True``; (2) a bare ``.join()`` with no
timeout flags; (3) every per-key load future (a dict literal with an
``"event"`` key stored under a subscript) has an owner that resolves it
on all exit paths: an ``except BaseException`` handler that stores the
``"error"`` slot and ``.set()``s the event, plus a success-path
``.set()``.

**The artifact.**  :func:`build_taxonomy` emits the closed catalog: per
error class its module, bases, ``retryable``, ``wire_name``, mint and
handler sites (line-number-independent ``file::Class.method`` ids), and
the raise -> outcome edges (:data:`OUTCOME_CLASSES`), taken from the
recorder calls (``_finish`` / ``_finish_locked`` / ``_count_outcome``
with a literal outcome), typed-handler bodies, raise-context recording,
and the broad accounting backstops (recorded as the wildcard error
``"*"``).  A class's effective outcomes are its direct edges plus its
taxonomy ancestors'.  A minted error with no effective outcome and no
backstop fails (R16).  :func:`diff_taxonomy` is the gate: a new error
class, a new raise -> outcome edge, or a drifted ``retryable`` /
``wire_name`` needs a reviewed ``--write-taxonomy`` diff; vanished
entries report stale.

Pure stdlib: no imports of the checked modules.
"""

from __future__ import annotations

import ast
import json
import pathlib

from esac_tpu_torch.lint.ast_rules import _alias_map, _dotted, iter_python_files
from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.lockgraph import FLEET_PREFIXES, PASS_PREFIXES
from esac_tpu_torch.lint.suppress import (
    is_suppressed,
    note_usage,
    parse_suppressions,
    record_usage,
)

FAULT_TAXONOMY_NAME = "esac_tpu_torch/lint/fault_taxonomy.json"

# The taxonomy roots: deriving from either (transitively, inside fleet
# scope) makes a class a member.
TAXONOMY_ROOTS = ("ServeError", "ManifestError")

# The closed outcome vocabulary a typed error may land in (the JAX
# package's, kept).  "quarantined" is the scene/replica-level terminal class —
# carried by breaker and fleet bookkeeping, not per-request counters.
OUTCOME_CLASSES = ("served", "shed", "expired", "degraded", "failed",
                   "quarantined")

# Builtin exception classes whose MINTING in fleet scope flags R16.
_BUILTIN_RAISES = frozenset({
    "Exception", "BaseException", "ValueError", "TypeError",
    "RuntimeError", "AssertionError", "KeyError", "IndexError",
    "LookupError", "AttributeError", "OSError", "IOError",
    "NotImplementedError", "ArithmeticError", "ZeroDivisionError",
    "StopIteration", "FileNotFoundError", "PermissionError",
    "TimeoutError", "InterruptedError", "BufferError", "EOFError",
})

# The sanctioned R16 near-miss scope: constructor-argument validation
# that cannot outlive construction (__post_init__ is the frozen-
# dataclass spelling of the same thing).
_INIT_SCOPES = ("__init__", "__post_init__")

_BROAD_EXCEPTS = ("Exception", "BaseException")

# Attribute-call names that count as R17 disposal (resolve/record).
_RESOLVE_ATTRS = frozenset({"set", "inc", "observe", "add", "append",
                            "notify", "notify_all"})
_RESOLVE_PREFIXES = ("_finish", "_record", "_abandon", "_on_worker",
                     "_note")


def fault_pass_needed(files) -> bool:
    """Mirror of lockgraph.lock_pass_needed for the fault-flow pass:
    full runs always analyze; scoped runs only when a fleet or lint
    file changed."""
    if files is None:
        return True
    return any(
        f.startswith(PASS_PREFIXES) and f.endswith(".py") for f in files
    )


# --------------------------------------------------------------------------
# small AST helpers

def _class_name_of(node, aliases) -> str | None:
    """The bare class name a raise/except/base expression refers to
    (``ShedError``, ``slo.ShedError`` -> ``ShedError``), or None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        dotted = _dotted(node, aliases)
        if dotted:
            return dotted.rsplit(".", 1)[-1]
        return node.attr
    return None


def _handler_names(handler: ast.ExceptHandler, aliases) -> list[str | None]:
    """Exception class names an except clause catches; [None] for bare."""
    t = handler.type
    if t is None:
        return [None]
    if isinstance(t, ast.Tuple):
        return [_class_name_of(e, aliases) for e in t.elts]
    return [_class_name_of(t, aliases)]


def _outcome_literals(call: ast.Call) -> list[str]:
    """Literal outcome-class strings among a call's args/kwargs."""
    out = []
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Constant) and a.value in OUTCOME_CLASSES:
            out.append(a.value)
    return out


def _refs_name(node, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _line(lines, lineno):
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


# --------------------------------------------------------------------------
# the analysis

class _ErrorClass:
    """One taxonomy member's statically collected facts."""

    def __init__(self, name: str, rel: str, bases: list[str]):
        self.name = name
        self.rel = rel
        self.bases = bases
        self.retryable = None       # literal bool, or None if not explicit
        self.wire_name = None       # literal str, or None if not explicit
        self.lineno = 0


class _Analysis:
    def __init__(self, root: pathlib.Path, prefixes=FLEET_PREFIXES):
        self.root = pathlib.Path(root)
        self.prefixes = prefixes
        # rel -> (tree, aliases, lines, per_line, per_file)
        self.files: dict[str, tuple] = {}
        self.errors: dict[str, _ErrorClass] = {}
        # (error name | "*", outcome) -> set of provenance fn ids
        self.edges: dict[tuple[str, str], set] = {}
        self.raise_sites: dict[str, set] = {}
        self.handler_sites: dict[str, set] = {}
        self.findings: list[Finding] = []
        # (rel, class name | None, fn name) -> set of taxonomy classes
        # the function returns constructed (the `return ShedError(...)`
        # admission idiom — `raise why` resolves through this).
        self._fn_returns: dict[tuple, set] = {}
        self._load()
        self._collect_classes()
        self._collect_returns()
        for rel in sorted(self.files):
            self._walk_file(rel)
        self._taxonomy_checks()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.text))

    # ---- loading ----

    def _load(self) -> None:
        for rel in iter_python_files(self.root):
            if not rel.startswith(self.prefixes):
                continue
            try:
                source = (self.root / rel).read_text()
                tree = ast.parse(source)
            except (OSError, SyntaxError):
                continue  # R1's problem, not ours
            per_line, per_file = parse_suppressions(source)
            self.files[rel] = (tree, _alias_map(tree), source.splitlines(),
                               per_line, per_file)

    def _emit(self, rule: str, rel: str, node, text: str, message: str):
        _, _, lines, per_line, per_file = self.files[rel]
        lineno = getattr(node, "lineno", 0)
        if is_suppressed(rule, lineno, per_line, per_file, path=rel):
            return
        self.findings.append(Finding(rule, rel, lineno, text, message))

    # ---- pass 1: the error-class table ----

    def _collect_classes(self) -> None:
        raw: dict[str, tuple] = {}
        for rel, (tree, aliases, *_rest) in self.files.items():
            for node in ast.walk(tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = [b for b in
                         (_class_name_of(x, aliases) for x in node.bases)
                         if b is not None]
                if node.name not in raw:
                    raw[node.name] = (rel, node, bases)
        members = set(n for n in TAXONOMY_ROOTS if n in raw)
        changed = True
        while changed:
            changed = False
            for name, (_rel, _node, bases) in raw.items():
                if name not in members and any(b in members for b in bases):
                    members.add(name)
                    changed = True
        for name in members:
            rel, node, bases = raw[name]
            ec = _ErrorClass(name, rel, bases)
            ec.lineno = node.lineno
            for item in node.body:
                tgt = None
                if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                        and isinstance(item.targets[0], ast.Name):
                    tgt = item.targets[0].id
                    val = item.value
                elif isinstance(item, ast.AnnAssign) \
                        and isinstance(item.target, ast.Name) \
                        and item.value is not None:
                    tgt = item.target.id
                    val = item.value
                if tgt == "retryable" and isinstance(val, ast.Constant) \
                        and isinstance(val.value, bool):
                    ec.retryable = val.value
                elif tgt == "wire_name" and isinstance(val, ast.Constant) \
                        and isinstance(val.value, str):
                    ec.wire_name = val.value
            self.errors[name] = ec

    # ---- pass 2: admission-idiom return classes ----

    def _collect_returns(self) -> None:
        for rel, (tree, aliases, *_rest) in self.files.items():
            for node in ast.walk(tree):
                if not isinstance(node, ast.FunctionDef):
                    continue
                cls = self._owner_class(tree, node)
                returned = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Return) and \
                            isinstance(sub.value, ast.Call):
                        name = _class_name_of(sub.value.func, aliases)
                        if name in self.errors:
                            returned.add(name)
                if returned:
                    self._fn_returns[(rel, cls, node.name)] = returned

    @staticmethod
    def _owner_class(tree, fn) -> str | None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and fn in node.body:
                return node.name
        return None

    # ---- pass 3: per-function fault-flow walk ----

    def _walk_file(self, rel: str) -> None:
        tree, aliases, *_rest = self.files[rel]
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        self._walk_fn(rel, node.name, item, [item.name])
            elif isinstance(node, ast.FunctionDef):
                self._walk_fn(rel, None, node, [node.name])

    def _fnid(self, rel: str, cls: str | None, stack: list) -> str:
        qual = ".".join(([cls] if cls else []) + stack)
        return f"{rel}::{qual}"

    def _walk_fn(self, rel, cls, fn, stack) -> None:
        _tree, aliases, lines, *_rest = self.files[rel]
        fnid = self._fnid(rel, cls, stack)
        in_init = len(stack) == 1 and stack[0] in _INIT_SCOPES
        # local name -> set of taxonomy classes it may hold (assigned
        # from a constructor or an admission-idiom helper call).
        local_err: dict[str, set] = {}

        def resolve_call_classes(call: ast.Call) -> set:
            """Taxonomy classes a call expression may produce."""
            name = _class_name_of(call.func, aliases)
            if name in self.errors:
                return {name}
            # self._helper(...) / module_fn(...) admission idiom
            if isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Name) and \
                    call.func.value.id == "self":
                return set(self._fn_returns.get(
                    (rel, cls, call.func.attr), ()))
            if isinstance(call.func, ast.Name):
                return set(self._fn_returns.get(
                    (rel, None, call.func.id), ()))
            return set()

        def minted_in_expr(node) -> set:
            """Taxonomy classes constructed anywhere inside ``node``
            (direct calls, lambdas, locals with known error type)."""
            out = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = _class_name_of(sub.func, aliases)
                    if name in self.errors:
                        out.add(name)
                elif isinstance(sub, ast.Name) and sub.id in local_err:
                    out |= local_err[sub.id]
            return out

        def add_edge(err: str, outcome: str) -> None:
            self.edges.setdefault((err, outcome), set()).add(fnid)

        def scan_call(call: ast.Call) -> None:
            """Rule (a): recorder call carrying BOTH a minted taxonomy
            error and a literal outcome; plus R18 thread/join checks
            and mint-site bookkeeping."""
            outcomes = _outcome_literals(call)
            minted = set()
            for a in list(call.args) + [kw.value for kw in call.keywords]:
                minted |= minted_in_expr(a)
            for c in sorted(minted):
                self.raise_sites.setdefault(c, set()).add(fnid)
                for o in outcomes:
                    add_edge(c, o)
            # R18: thread creation must be daemon=True.
            dotted = _dotted(call.func, aliases)
            if dotted in ("threading.Thread", "Thread"):
                daemon = next(
                    (kw.value for kw in call.keywords
                     if kw.arg == "daemon"), None)
                if not (isinstance(daemon, ast.Constant)
                        and daemon.value is True):
                    self._emit(
                        "R18", rel, call, f"thread:{fnid}",
                        f"{_line(lines, call.lineno)!r}: Thread created "
                        "without daemon=True in fleet scope — a non-daemon "
                        "thread wedged in a device call pins the process "
                        "at exit; create it daemon and give close() a "
                        "bounded join",
                    )
            # R18: bare .join() (no timeout) is an unbounded wait.
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "join" \
                    and not call.args and not call.keywords:
                self._emit(
                    "R18", rel, call, f"join:{fnid}",
                    f"{_line(lines, call.lineno)!r}: bare join() in fleet "
                    "scope — a thread wedged in a device call makes this "
                    "wait forever; use join(timeout) then abandon the "
                    "daemon thread (the dispatcher-watchdog idiom)",
                )

        def scan_raise(node: ast.Raise) -> None:
            """R16 + mint-site bookkeeping for raise statements."""
            exc = node.exc
            if exc is None:
                return  # bare re-raise: propagation
            call = exc if isinstance(exc, ast.Call) else None
            target = call.func if call is not None else exc
            name = _class_name_of(target, aliases)
            if name in self.errors:
                self.raise_sites.setdefault(name, set()).add(fnid)
                return
            if isinstance(target, ast.Name) and call is None:
                # ``raise e`` / ``raise why``: propagation of an object
                # minted elsewhere; the admission idiom resolves below
                # through local_err (raise-context edges), never R16.
                return
            if name in _BUILTIN_RAISES and not in_init:
                self._emit(
                    "R16", rel, node, f"raise:{name}@{fnid}",
                    f"{_line(lines, node.lineno)!r}: mints untyped "
                    f"{name} in fleet scope — callers cannot classify it "
                    "into an outcome; raise a ServeError/ManifestError "
                    "taxonomy member (or validate in __init__/"
                    "__post_init__, the sanctioned near-miss)",
                )

        def raise_classes(node: ast.Raise) -> set:
            exc = node.exc
            if exc is None:
                return set()
            if isinstance(exc, ast.Call):
                return resolve_call_classes(exc)
            if isinstance(exc, ast.Name):
                return set(local_err.get(exc.id, ()))
            return set()

        def handler_is_broad(handler: ast.ExceptHandler) -> bool:
            names = _handler_names(handler, aliases)
            return any(n is None or n in _BROAD_EXCEPTS for n in names)

        def handler_disposes(handler: ast.ExceptHandler) -> bool:
            for sub in ast.walk(handler):
                if isinstance(sub, ast.Raise):
                    return True
                if isinstance(sub, ast.AugAssign):
                    return True
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    if any(isinstance(t, (ast.Subscript, ast.Attribute))
                           for t in targets):
                        return True
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    attr = sub.func.attr
                    if attr in _RESOLVE_ATTRS or \
                            attr.startswith(_RESOLVE_PREFIXES):
                        return True
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id.startswith(_RESOLVE_PREFIXES):
                    return True
            return False

        def scan_handler(handler: ast.ExceptHandler) -> None:
            names = [n for n in _handler_names(handler, aliases)
                     if n in self.errors]
            for n in names:
                self.handler_sites.setdefault(n, set()).add(fnid)
            # Typed-handler edges: an outcome literal anywhere in the
            # body (recorder arg or stored assignment value) maps every
            # named taxonomy class onto it.
            outcomes = set()
            for sub in ast.walk(handler):
                if isinstance(sub, ast.Call):
                    outcomes.update(_outcome_literals(sub))
                elif isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Constant) and \
                        sub.value.value in OUTCOME_CLASSES:
                    outcomes.add(sub.value.value)
            for n in names:
                for o in sorted(outcomes):
                    add_edge(n, o)
            if handler_is_broad(handler):
                # Wildcard backstop edges: a recorder call that carries
                # the caught object AND a literal outcome accounts for
                # ANY error reaching this handler.
                caught = handler.name
                if caught:
                    for sub in ast.walk(handler):
                        if isinstance(sub, ast.Call) and \
                                _refs_name(sub, caught):
                            for o in _outcome_literals(sub):
                                add_edge("*", o)
                if not handler_disposes(handler):
                    shape = "bare except" if handler.type is None else \
                        f"except {_class_name_of(handler.type, aliases)}" \
                        if not isinstance(handler.type, ast.Tuple) else \
                        "except (...broad...)"
                    self._emit(
                        "R17", rel, handler, f"swallow:{fnid}",
                        f"{shape} at line {handler.lineno} swallows: the "
                        "handler neither re-raises, converts to a typed "
                        "taxonomy error, resolves a future/_finish, nor "
                        "records a counter/outcome — a fault must end in "
                        "exactly one accounted outcome; "
                        "the cache.py BaseException guard is the "
                        "allowlisted shape",
                    )

        def track_assign(stmt) -> None:
            if isinstance(stmt, ast.Assign) and \
                    isinstance(stmt.value, ast.Call):
                classes = resolve_call_classes(stmt.value)
                if classes:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            local_err[t.id] = set(classes)

        def walk_block(body: list) -> None:
            """One statement list: sequential raise-context tracking
            (a recorder call with a literal outcome followed by a raise
            in the same block binds the minted classes to it), plus
            recursion into nested blocks.  No per-node scans here —
            those run exactly once in the ``scan`` pass below."""
            pending: list[str] = []
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested defs get their own _walk_fn pass
                track_assign(stmt)
                if isinstance(stmt, ast.Expr) and \
                        isinstance(stmt.value, ast.Call):
                    outcomes = _outcome_literals(stmt.value)
                    if outcomes:
                        pending = outcomes
                if isinstance(stmt, ast.Raise):
                    for c in sorted(raise_classes(stmt)):
                        self.raise_sites.setdefault(c, set()).add(fnid)
                        for o in pending:
                            add_edge(c, o)
                for field in ("body", "orelse", "finalbody"):
                    nested = getattr(stmt, field, None)
                    if nested:
                        walk_block(nested)
                for handler in getattr(stmt, "handlers", []) or []:
                    walk_block(handler.body)

        def scan(node) -> None:
            """Generic per-node scan (rule-a edges, R16-R18, handler
            edges): visits every node of this function EXACTLY once,
            pruning nested defs (their own walk contexts)."""
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                if isinstance(child, ast.Call):
                    scan_call(child)
                elif isinstance(child, ast.Raise):
                    scan_raise(child)
                elif isinstance(child, ast.ExceptHandler):
                    scan_handler(child)
                scan(child)

        # Sequential pass first: it fills local_err for the whole
        # function, which the generic scan's minted_in_expr reads.
        walk_block(fn.body)
        scan(fn)
        self._check_future_owner(rel, cls, fn, fnid, aliases, lines)
        # Nested defs are their own (non-init) walk contexts.
        for sub in ast.walk(fn):
            if isinstance(sub, ast.FunctionDef) and sub is not fn and \
                    self._direct_parent_is(fn, sub):
                self._walk_fn(rel, cls, sub, stack + [sub.name])

    @staticmethod
    def _direct_parent_is(parent, child) -> bool:
        """True when ``child`` is nested in ``parent`` with no other
        FunctionDef in between (each nesting level walks its own)."""
        for node in ast.walk(parent):
            if isinstance(node, ast.FunctionDef) and node is not parent \
                    and node is not child:
                if any(n is child for n in ast.walk(node)):
                    return False
        return any(n is child for n in ast.walk(parent))

    def _check_future_owner(self, rel, cls, fn, fnid, aliases, lines):
        """R18 future-lifecycle: a function that mints a per-key load
        future must resolve it on all exit paths (see module docstring)."""
        mints = False
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict):
                keys = {k.value for k in sub.value.keys
                        if isinstance(k, ast.Constant)}
                if "event" in keys and any(
                        isinstance(t, ast.Subscript) for t in sub.targets):
                    mints = True
        if not mints:
            return
        guarded = False
        set_calls = 0
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "set" and not sub.args:
                set_calls += 1
            if isinstance(sub, ast.ExceptHandler) and \
                    _class_name_of(sub.type, aliases) == "BaseException":
                stores_error = any(
                    isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Subscript) and
                        isinstance(t.slice, ast.Constant) and
                        t.slice.value == "error" for t in n.targets)
                    for n in ast.walk(sub)
                )
                sets_event = any(
                    isinstance(n, ast.Call) and
                    isinstance(n.func, ast.Attribute) and
                    n.func.attr == "set" for n in ast.walk(sub)
                )
                if stores_error and sets_event:
                    guarded = True
        if not guarded or set_calls < 2:
            self._emit(
                "R18", rel, fn, f"future:{fnid}",
                f"{fnid} mints a per-key load future but does not resolve "
                "it on every exit path: the owner needs an `except "
                "BaseException` that stores the \"error\" slot and sets "
                "the event, plus the success-path set() — an un-set Event "
                "strands every waiter forever (the cache.get idiom)",
            )

    # ---- pass 4: taxonomy-contract checks ----

    def _effective_outcomes(self, name: str) -> set:
        """Direct edges plus taxonomy ancestors' (a ShedError handler
        disposes of every ShedError subclass)."""
        out = set()
        seen = set()
        stack = [name]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            out |= {o for (e, o) in self.edges if e == n}
            ec = self.errors.get(n)
            if ec is not None:
                stack.extend(b for b in ec.bases if b in self.errors)
        return out

    def _taxonomy_checks(self) -> None:
        wildcard = any(e == "*" for (e, _o) in self.edges)
        wires: dict[str, str] = {}
        for name in sorted(self.errors):
            ec = self.errors[name]
            node_stub = type("L", (), {"lineno": ec.lineno})()
            if ec.retryable is None:
                self._emit(
                    "R16", ec.rel, node_stub, f"error:{name}:retryable",
                    f"taxonomy error {name} lacks an explicit literal "
                    "`retryable` bool — every member carries its own "
                    "flag (the breaker/failover contract reads it)",
                )
            if ec.wire_name is None:
                self._emit(
                    "R16", ec.rel, node_stub, f"error:{name}:wire_name",
                    f"taxonomy error {name} lacks an explicit literal "
                    "`wire_name` str — the stable cross-wire identity "
                    "(ROADMAP item 2 serialization seam)",
                )
            elif ec.wire_name in wires:
                self._emit(
                    "R16", ec.rel, node_stub, f"error:{name}:wire_dup",
                    f"taxonomy error {name} reuses wire_name "
                    f"{ec.wire_name!r} (also {wires[ec.wire_name]}) — "
                    "wire names identify classes and must be unique",
                )
            else:
                wires[ec.wire_name] = name
            if self.raise_sites.get(name) and \
                    not self._effective_outcomes(name) and not wildcard:
                self._emit(
                    "R16", ec.rel, node_stub, f"error:{name}:no-outcome",
                    f"taxonomy error {name} is minted but maps to NO "
                    "outcome class: no typed handler, recorder call or "
                    "accounting backstop disposes of it — a fault that "
                    "ends in no accounted outcome",
                )

    # ---- the artifact ----

    def taxonomy(self) -> dict:
        errors = {}
        for name in sorted(self.errors):
            ec = self.errors[name]
            errors[name] = {
                "module": ec.rel,
                "bases": sorted(ec.bases),
                "retryable": ec.retryable,
                "wire_name": ec.wire_name,
                "raise_sites": sorted(self.raise_sites.get(name, ())),
                "handler_sites": sorted(self.handler_sites.get(name, ())),
                "outcomes": sorted(self._effective_outcomes(name)),
            }
        edges = [
            {"error": e, "outcome": o, "via": sorted(via)}
            for (e, o), via in sorted(self.edges.items())
        ]
        return {"errors": errors, "edges": edges,
                "outcome_classes": list(OUTCOME_CLASSES)}


# --------------------------------------------------------------------------
# public API

# Same memo contract as lockgraph: one full lint run needs the analysis
# twice (run_layer1's R16-R18 pass + the CLI's committed-taxonomy diff).
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


def build_taxonomy(root, prefixes=FLEET_PREFIXES) -> dict:
    return analyze(root, prefixes).taxonomy()


def run_faultflow_rules(root, files=None, prefixes=FLEET_PREFIXES):
    """R16/R17/R18 findings over the fleet scope of ``root``.  The whole
    scope is always analyzed — the taxonomy is a fleet-global property —
    but the pass is skipped entirely when a scoped run touched no
    fleet/lint file (``--changed`` fast mode).  The committed-taxonomy
    DIFF is the CLI's job (ledger pattern)."""
    if not fault_pass_needed(files):
        return []
    return analyze(root, prefixes).findings


def write_taxonomy(path: pathlib.Path, taxonomy: dict) -> None:
    data = {
        "comment": "The port's fault taxonomy.  The "
                   "closed typed-error catalog of the serving fleet: "
                   "per error its module, retryable flag, stable "
                   "wire_name (the serialization identity), mint and "
                   "handler sites (file::Class.method, line-number-"
                   "independent), and the raise->outcome edges — which "
                   "accounted outcome class each error lands in "
                   "(\"*\" is the broad accounting backstop).  A NEW "
                   "error class or raise->outcome edge fails tier-1 "
                   "until regenerated with `python -m esac_tpu_torch.lint "
                   "--write-taxonomy` and reviewed; the runtime "
                   "witness (esac_tpu_torch/lint/witness.py OutcomeWitness) asserts "
                   "every error type observed in the chaos/fleet drills "
                   "is a member and lands inside these edges.",
        **taxonomy,
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def load_taxonomy(path: pathlib.Path) -> dict | None:
    if not path.exists():
        return None
    data = json.loads(path.read_text())
    return {
        "errors": data.get("errors", {}),
        "edges": data.get("edges", []),
        "outcome_classes": data.get("outcome_classes",
                                    list(OUTCOME_CLASSES)),
    }


def _edge_map(taxonomy: dict) -> dict[tuple[str, str], list[str]]:
    return {
        (e["error"], e["outcome"]): list(e.get("via", []))
        for e in taxonomy.get("edges", [])
    }


def diff_taxonomy(committed: dict, current: dict):
    """-> (R16 findings, stale notes), the v3/v4 gate contract: a NEW
    error class, a NEW raise->outcome edge, or a drifted
    retryable/wire_name contract fails until reviewed; vanished or
    drifted-provenance entries are stale (regenerate + review)."""
    findings: list[Finding] = []
    stale: list[str] = []
    want_err = committed.get("errors", {})
    have_err = current.get("errors", {})
    for name in sorted(set(have_err) - set(want_err)):
        findings.append(Finding(
            "R16", FAULT_TAXONOMY_NAME, 0, f"error:{name}",
            f"unreviewed new taxonomy error {name} "
            f"({have_err[name].get('module')}): not in the committed "
            f"{FAULT_TAXONOMY_NAME} — if intentional, regenerate with "
            "`python -m esac_tpu_torch.lint --write-taxonomy`, review "
            "the diff (is retryable right? is the wire name stable and "
            "unique? which outcomes dispose of it?), and commit",
        ))
    for name in sorted(set(want_err) - set(have_err)):
        stale.append(
            f"committed taxonomy error {name} no longer exists — "
            "regenerate with --write-taxonomy"
        )
    for name in sorted(set(want_err) & set(have_err)):
        w, h = want_err[name], have_err[name]
        for field in ("retryable", "wire_name"):
            if w.get(field) != h.get(field):
                findings.append(Finding(
                    "R16", FAULT_TAXONOMY_NAME, 0,
                    f"contract:{name}:{field}",
                    f"taxonomy error {name} changed {field}: "
                    f"{w.get(field)!r} -> {h.get(field)!r} — the wire "
                    "contract is load-bearing (item-2 serialization); "
                    "if intentional, regenerate with "
                    "--write-taxonomy and review",
                ))
        for field in ("raise_sites", "handler_sites", "outcomes"):
            if w.get(field) != h.get(field):
                stale.append(
                    f"taxonomy error {name} {field} drifted "
                    f"({w.get(field)} -> {h.get(field)}) — regenerate "
                    "with --write-taxonomy and review the diff"
                )
    want = _edge_map(committed)
    have = _edge_map(current)
    for (err, outcome), via in sorted(have.items()):
        old = want.get((err, outcome))
        if old is None:
            findings.append(Finding(
                "R16", FAULT_TAXONOMY_NAME, 0, f"edge:{err}->{outcome}",
                f"unreviewed raise->outcome edge {err} -> {outcome} "
                f"(via {', '.join(via)}): not in the committed "
                f"{FAULT_TAXONOMY_NAME} — if intentional, regenerate "
                "with `python -m esac_tpu_torch.lint --write-taxonomy` "
                "and review (does the new disposal keep the accounting "
                "exact?)",
            ))
        elif sorted(old) != sorted(via):
            stale.append(
                f"taxonomy edge {err} -> {outcome} changed provenance "
                f"({', '.join(old)} -> {', '.join(via)}) — regenerate "
                "with --write-taxonomy"
            )
    for (err, outcome) in sorted(set(want) - set(have)):
        stale.append(
            f"committed taxonomy edge {err} -> {outcome} is no longer "
            "taken by any code path — regenerate with "
            "--write-taxonomy"
        )
    return findings, stale


def effective_outcomes(taxonomy: dict) -> dict[str, set]:
    """Per-error effective outcome sets from a (committed) taxonomy
    dict: direct edges + taxonomy ancestors' + the wildcard backstop —
    the membership test the runtime OutcomeWitness applies to every
    observed (error type, outcome) pair."""
    errors = taxonomy.get("errors", {})
    direct: dict[str, set] = {}
    wildcard: set = set()
    for e in taxonomy.get("edges", []):
        if e["error"] == "*":
            wildcard.add(e["outcome"])
        else:
            direct.setdefault(e["error"], set()).add(e["outcome"])
    out: dict[str, set] = {}
    for name in errors:
        acc = set(wildcard)
        seen: set = set()
        stack = [name]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            acc |= direct.get(n, set())
            stack.extend(b for b in errors.get(n, {}).get("bases", ())
                         if b in errors)
        out[name] = acc
    return out
