"""Static layer, R10: lock discipline per class (counterpart of
``esac_tpu/lint/concurrency.py``), over the port's ``serve/``,
``registry/``, ``obs/``, ``fleet/`` and ``retrieval/``.

- **Locks**: instance attributes assigned ``threading.Lock()`` /
  ``RLock()`` in ``__init__``, plus ``threading.Condition(...)`` aliases
  (a Condition built over an existing lock is that lock: the dispatcher's
  ``_work`` / ``_space`` waiters share ``_lock``).
- **Access map**: every ``self.<attr>`` read or mutation in every method,
  classified locked (lexically inside ``with self.<lock>:``) or unlocked.
  Mutations are attribute assignment / aug-assign / del, subscript stores
  and calls of known mutating methods (``append`` / ``pop`` / ``clear`` /
  ``move_to_end`` / ...).
- **Helper propagation**: a private method whose every intra-class call
  site is locked is analysed as lock-held, to a fixpoint.
- **Verdict**: an attribute mutated after ``__init__`` with both locked and
  unlocked access sites is a finding at each unlocked site.  Attributes
  never mutated after ``__init__`` are exempt, and so are attributes with
  no locked site at all: R10 polices inconsistent discipline.

Pure ``ast``: no imports of the checked modules.
"""

from __future__ import annotations

import ast
import pathlib

from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.lockgraph import FLEET_PREFIXES
from esac_tpu_torch.lint.suppress import is_suppressed, parse_suppressions

_MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse", "rotate",
}

_EXEMPT_METHODS = {"__init__", "__new__", "__del__"}


def _r10_scope(rel: str) -> bool:
    return rel.startswith(FLEET_PREFIXES)


def _self_attr(node) -> str | None:
    """'attr' for ``self.attr`` expressions, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _lock_aliases(cls: ast.ClassDef) -> set[str]:
    """Attributes that hold the instance lock (or a Condition over it)."""
    locks: set[str] = set()
    init = next(
        (n for n in cls.body
         if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
        None,
    )
    if init is None:
        return locks
    for node in ast.walk(init):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        attr = _self_attr(node.targets[0])
        if attr is None or not isinstance(node.value, ast.Call):
            continue
        func = node.value.func
        dotted = ""
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name):
            dotted = f"{func.value.id}.{func.attr}"
        elif isinstance(func, ast.Name):
            dotted = func.id
        if dotted in ("threading.Lock", "threading.RLock", "Lock", "RLock"):
            locks.add(attr)
        elif dotted in ("threading.Condition", "Condition"):
            # Condition(self.X) shares X; bare Condition() owns its lock.
            arg_attr = _self_attr(node.value.args[0]) if node.value.args \
                else None
            if arg_attr is None or arg_attr in locks:
                locks.add(attr)
    return locks


class _Access:
    __slots__ = ("attr", "mutates", "locked", "method", "lineno")

    def __init__(self, attr, mutates, locked, method, lineno):
        self.attr = attr
        self.mutates = mutates
        self.locked = locked
        self.method = method
        self.lineno = lineno


def _method_accesses(method: ast.FunctionDef, locks: set[str]):
    """-> (accesses, call_sites): attribute touches and intra-class method
    calls, each tagged with lexical lock state.  Nested function bodies are
    analyzed as UNLOCKED — a closure built under the lock runs later,
    possibly without it."""
    accesses: list[_Access] = []
    call_sites: list[tuple[str, bool]] = []  # (callee method, locked)

    def visit(node, locked):
        if isinstance(node, ast.With):
            holds = any(
                _self_attr(item.context_expr) in locks
                for item in node.items
            )
            for item in node.items:
                visit(item.context_expr, locked)
            for child in node.body:
                visit(child, locked or holds)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not method:
            # A closure built here runs later, possibly without the lock:
            # its body starts over as unlocked (an inner `with self._lock:`
            # still counts).
            for child in ast.iter_child_nodes(node):
                visit(child, False)
            return

        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = node.targets if isinstance(node, (ast.Assign, ast.Delete)) \
                else [node.target]
            for t in targets:
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                attr = _self_attr(base)
                if attr is not None:
                    accesses.append(
                        _Access(attr, True, locked, method.name, t.lineno)
                    )
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATING_METHODS:
                owner = _self_attr(node.func.value)
                if owner is not None:
                    accesses.append(_Access(
                        owner, True, locked, method.name, node.lineno
                    ))
            callee = _self_attr(node.func)
            if callee is not None:
                call_sites.append((callee, locked))
        attr = _self_attr(node)
        if attr is not None and \
                isinstance(getattr(node, "ctx", None), ast.Load):
            accesses.append(
                _Access(attr, False, locked, method.name, node.lineno)
            )
        for child in ast.iter_child_nodes(node):
            if isinstance(node, ast.Call) and child is node.func and \
                    isinstance(child, ast.Attribute) and \
                    _self_attr(child) is not None:
                continue  # self._helper(...) is a call site, not a touch
            visit(child, locked)

    for stmt in method.body:
        visit(stmt, False)
    return accesses, call_sites


def _analyze_class(rel, cls: ast.ClassDef, lines, per_line, per_file):
    locks = _lock_aliases(cls)
    if not locks:
        return []
    methods = [
        n for n in cls.body
        if isinstance(n, ast.FunctionDef)
    ]
    raw = {
        m.name: _method_accesses(m, locks) for m in methods
    }
    # Fixpoint: a private helper whose every intra-class call site is
    # locked is itself analyzed as lock-held.
    locked_ctx: set[str] = set()
    while True:
        changed = False
        sites: dict[str, list[bool]] = {}
        for caller, (_, call_sites) in raw.items():
            for callee, locked in call_sites:
                effective = locked or caller in locked_ctx
                sites.setdefault(callee, []).append(effective)
        for m in methods:
            name = m.name
            if name in locked_ctx or not name.startswith("_") or \
                    name.startswith("__"):
                continue
            if sites.get(name) and all(sites[name]):
                locked_ctx.add(name)
                changed = True
        if not changed:
            break

    by_attr: dict[str, list[_Access]] = {}
    for name, (accesses, _) in raw.items():
        if name in _EXEMPT_METHODS:
            continue
        for a in accesses:
            if a.attr in locks:
                continue
            if name in locked_ctx:
                a.locked = True
            by_attr.setdefault(a.attr, []).append(a)

    out = []
    for attr, accesses in sorted(by_attr.items()):
        if not any(a.mutates for a in accesses):
            continue  # immutable post-init: unlocked reads are the design
        locked_sites = [a for a in accesses if a.locked]
        unlocked_sites = [a for a in accesses if not a.locked]
        if not locked_sites or not unlocked_sites:
            continue  # consistent discipline (all-in or all-out)
        guarded_in = sorted({a.method for a in locked_sites})
        # One report per site: a mutating-method call also registers the
        # underlying attribute read — collapse to the mutation.
        by_site: dict[tuple, _Access] = {}
        for a in unlocked_sites:
            key = (a.method, a.lineno)
            prev = by_site.get(key)
            if prev is None or (a.mutates and not prev.mutates):
                by_site[key] = a
        for a in sorted(by_site.values(), key=lambda a: a.lineno):
            f = Finding(
                "R10", rel, a.lineno, _line(lines, a.lineno),
                f"{cls.name}.{attr} is "
                f"{'mutated' if a.mutates else 'read'} in {a.method}() "
                "without the instance lock, but the same attribute is "
                f"lock-guarded in {', '.join(guarded_in)}(): every access "
                "to lock-protected mutable state must hold the lock "
                "(serve-layer concurrency invariant)",
            )
            if not is_suppressed("R10", a.lineno, per_line, per_file,
                                 path=rel):
                out.append(f)
    return out


def _line(lines, lineno):
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def run_concurrency_rules(root, files=None) -> list[Finding]:
    from esac_tpu_torch.lint.ast_rules import iter_python_files

    root = pathlib.Path(root)
    findings: list[Finding] = []
    for rel in iter_python_files(root, files):
        if not _r10_scope(rel):
            continue
        try:
            source = (root / rel).read_text()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError):
            continue  # R0 comes from the main python pass
        lines = source.splitlines()
        per_line, per_file = parse_suppressions(source)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                findings += _analyze_class(
                    rel, node, lines, per_line, per_file
                )
    return findings
