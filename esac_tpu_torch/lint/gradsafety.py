"""Static layer, R14/R15: grad-safety dataflow analysis (counterpart of
``esac_tpu/lint/gradsafety.py``).

R2 flags the raw norm and the bare sqrt; this pass covers the rest of the
domain edges over the differentiated scope (``esac_tpu_torch/{geometry,
ransac,train}/``):

- **Roots**: every scope function the gradient witnesses
  (:mod:`esac_tpu_torch.lint.gradcheck`) and the registry's ``grad=True``
  entries (:mod:`~.registry`) name -- parsed, not imported, so the pass
  stays in step with both -- plus the ``forward`` /
  ``backward`` pair of every ``torch.autograd.Function`` in scope
  (``_NormalEquations``, ``SoftInlierScores``, ``SoftInlierScoreSelect``;
  the JAX package's ``custom_vjp`` pairs) and every function handed to
  ``torch.autograd.grad`` / ``torch.func`` / ``checkpoint`` there.  The
  differentiated set is everything a root reaches through the call graph
  of :mod:`~esac_tpu_torch.lint.ast_rules`.
- **R14 -- unguarded domain-edge primitive**: ``/`` and ``torch.div`` /
  ``reciprocal`` with an eps-free denominator, ``acos`` / ``asin`` without
  a clamp into [-1, 1] on both sides, ``log`` and ``rsqrt`` of a maybe-zero
  value, and a fractional or negative ``pow`` / ``**`` of a maybe-zero
  base -- function and Tensor-method spellings alike.
- **R15 -- the where-VJP trap**: the same hazard inside a branch of
  ``torch.where``; the untaken branch's backward still runs.

Guards, credited by dataflow over the function's bindings: an eps-add
(a nonzero literal or an eps-named / ALL-CAPS constant), ``clamp`` /
``clamp_min`` / ``torch.maximum`` with a constant bound, the
``torch.where`` select-clamp, ``exp``, ``safe_norm`` / ``safe_sqrt``
(utils/num.py), and a helper whose every return is guarded.  The pass
over-approximates hazards: anything unresolvable counts as unguarded.

Pure ``ast``; inline ``# torch-lint: disable=R14(reason)`` suppressions
apply.  The runtime half is the degenerate-input gradient witness
(:mod:`esac_tpu_torch.lint.gradcheck`).
"""

from __future__ import annotations

import ast
import pathlib

from esac_tpu_torch.lint.ast_rules import (
    PACKAGE,
    _Module,
    _alias_map,
    _callees,
    _dotted,
    _line_text,
    _reachable,
    _resolve_function,
    iter_python_files,
)
from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.suppress import is_suppressed, parse_suppressions

# The differentiated packages the pass analyses...
GRAD_SCOPE_PREFIXES = tuple(f"{PACKAGE}/{d}/" for d in
                            ("geometry", "ransac", "train"))
# ...and what triggers the pass in --changed mode (editing the analysis
# itself re-runs it).
PASS_PREFIXES = GRAD_SCOPE_PREFIXES + (f"{PACKAGE}/lint/",)
# The modules whose build functions name the differentiated entry points:
# the gradient witnesses and the registry's grad=True entries.
WITNESS_MODULE = f"{PACKAGE}/lint/gradcheck.py"
REGISTRY_MODULE = f"{PACKAGE}/lint/registry.py"


def grad_pass_needed(files) -> bool:
    """Full runs always analyse; scoped runs only when a geometry / ransac
    / train or lint file changed."""
    if files is None:
        return True
    return any(
        f.startswith(PASS_PREFIXES) and f.endswith(".py") for f in files
    )


# Callables whose function argument enters differentiated scope.
_GRAD_WRAPPERS = {
    "torch.autograd.grad", "torch.autograd.functional.vjp",
    "torch.autograd.functional.jacobian", "torch.func.grad",
    "torch.func.vjp", "torch.func.grad_and_value", "torch.func.jacrev",
    "torch.func.jacfwd", "torch.utils.checkpoint.checkpoint",
}

# Callable names (trailing attribute) treated as guard producers.
_SAFE_CALLS = {"safe_norm", "safe_sqrt"}
# where produces the select-clamp idiom; exp is strictly positive.
_SELECT_CALLS = {"where"}
# Producers whose RANGE is within [-1, 1] (arccos/arcsin domination).
_BOUNDED_CALLS = {"cos", "sin", "tanh"}

_MAX_DEPTH = 12


def _is_eps_name(name: str) -> bool:
    """Names that denote a numeric guard constant by convention: anything
    containing 'eps', or an ALL-CAPS module constant (MIN_DEPTH, _EPS)."""
    bare = name.lstrip("_")
    return "eps" in name.lower() or (bare.isupper() and bare != "")


def _const_like(node: ast.AST) -> bool:
    """Nonzero numeric literal, eps-named constant, or a negation of one."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, complex)) and node.value != 0
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _const_like(node.operand)
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return name is not None and _is_eps_name(name)


class _Scope:
    """Per-function analysis scope: flow-ordered assignments, parameters
    (with annotations/defaults), and the owning module for helper and
    module-constant resolution."""

    def __init__(self, mod: _Module, fn: ast.AST):
        self.mod = mod
        self.fn = fn
        # name -> [(lineno, value expr)], flow-ordered single-target binds.
        self.assigns: dict[str, list[tuple[int, ast.AST]]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.assigns.setdefault(node.targets[0].id, []).append(
                    (node.lineno, node.value)
                )
        for binds in self.assigns.values():
            binds.sort()
        # Parameters of the scanned function (nested-def params stay
        # unresolved -> tainted, the conservative direction).
        self.params: dict[str, tuple[ast.AST | None, ast.AST | None]] = {}
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = fn.args
            all_args = args.posonlyargs + args.args + args.kwonlyargs
            defaults = [None] * (
                len(args.posonlyargs) + len(args.args) - len(args.defaults)
            ) + list(args.defaults)
            defaults += list(args.kw_defaults)
            for a, d in zip(all_args, defaults):
                self.params[a.arg] = (a.annotation, d)

    def latest_bind(self, name: str, before: int) -> ast.AST | None:
        binds = self.assigns.get(name)
        if not binds:
            return None
        prior = [v for ln, v in binds if ln <= before]
        return prior[-1] if prior else binds[-1][1]


def _param_guarded(scope: _Scope, name: str) -> bool | None:
    """None = not a parameter; else its guardedness: int/bool annotation
    (a Python number, no gradient) or a nonzero numeric default."""
    if name not in scope.params:
        return None
    ann, default = scope.params[name]
    if isinstance(ann, ast.Name) and ann.id in ("int", "bool"):
        return True
    if isinstance(default, ast.Constant) and \
            isinstance(default.value, (int, float)) and default.value != 0:
        return True
    return False


def _helper_return_guarded(scope: _Scope, fname: str, depth: int) -> bool | None:
    """One level of helper propagation: a same-module function whose every
    return expression is guarded makes its call results guarded (the
    ``lead_safe`` idiom of geometry/quartic.py).  None = not resolvable."""
    helper = scope.mod.functions.get(fname)
    if helper is None or depth > _MAX_DEPTH:
        return None
    returns = [
        n.value for n in ast.walk(helper)
        if isinstance(n, ast.Return) and n.value is not None
    ]
    if not returns:
        return None
    hscope = _Scope(scope.mod, helper)
    return all(
        _guarded(hscope, r, use_line=getattr(r, "lineno", 0),
                 depth=depth + 1)
        for r in returns
    )


def _guarded(scope: _Scope, node: ast.AST, use_line: int, depth: int = 0,
             _seen: frozenset = frozenset()) -> bool:
    """Is this expression's value bounded away from the domain edge in
    BOTH passes?  False whenever unresolvable (hazards over-approximate)."""
    if depth > _MAX_DEPTH:
        return False
    if _const_like(node):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _guarded(scope, node.operand, use_line, depth + 1, _seen)
    if isinstance(node, ast.IfExp):
        return (
            _guarded(scope, node.body, use_line, depth + 1, _seen)
            and _guarded(scope, node.orelse, use_line, depth + 1, _seen)
        )
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            # x + eps (either side): the canonical guard.
            return _const_like(node.left) or _const_like(node.right)
        if isinstance(node.op, (ast.Mult, ast.Div)):
            # nonzero * nonzero (const * where(...) etc.) stays nonzero.
            return (
                _guarded(scope, node.left, use_line, depth + 1, _seen)
                and _guarded(scope, node.right, use_line, depth + 1, _seen)
            )
        return False
    if isinstance(node, ast.Subscript):
        # Static shapes are nonzero ints; slicing a guarded array keeps the
        # elementwise floor.
        if isinstance(node.value, ast.Attribute) and node.value.attr == "shape":
            return True
        return _guarded(scope, node.value, use_line, depth + 1, _seen)
    if isinstance(node, ast.Call):
        tail, operand, rest = _call_parts(node, scope.mod.aliases)
        if tail in _SAFE_CALLS:
            return True
        if tail in _SELECT_CALLS:
            # The select-clamp idiom: torch.where(bad, floor, x).  Whether
            # the clamp is CORRECT is the runtime witness's job
            # (gradcheck); the static rule credits handling the edge.
            return True
        if tail == "exp" or tail in _STATIC_CALLS:
            return True
        if tail in ("maximum", "clamp", "clamp_min", "clip", "fmax"):
            # A floor needs a constant bound: clamp(x, min=1e-9) or
            # torch.maximum(x, MIN_DEPTH).  A floor of two tainted values
            # floors nothing.
            return any(_const_like(a) for a in rest if a is not None) or \
                any(_const_like(kw.value) for kw in node.keywords
                    if kw.arg in (None, "min", "other"))
        if tail in ("float", "double", "to", "as_tensor", "tensor",
                    "contiguous", "clone", "detach", "expand",
                    "expand_as", "reshape", "view", "unsqueeze",
                    "squeeze"):
            return operand is not None and _guarded(
                scope, operand, use_line, depth + 1, _seen
            )
        if isinstance(node.func, ast.Name):
            helper = _helper_return_guarded(scope, node.func.id, depth)
            if helper is not None:
                return helper
        return False
    if isinstance(node, ast.Attribute):
        # math.pi and friends are nonzero constants.
        return _is_eps_name(node.attr) or node.attr in ("pi", "e", "tau")
    if isinstance(node, ast.Name):
        if node.id in _seen:
            return False  # self-referential rebinding chain
        p = _param_guarded(scope, node.id)
        if p is not None:
            return p
        if _is_eps_name(node.id):
            return True
        bind = scope.latest_bind(node.id, use_line)
        if bind is not None:
            return _guarded(scope, bind, getattr(bind, "lineno", use_line),
                            depth + 1, _seen | {node.id})
        # Fall back to a module-level constant binding.
        for stmt in scope.mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == node.id:
                mscope = _Scope(scope.mod, scope.mod.tree)
                return _guarded(mscope, stmt.value, stmt.lineno, depth + 1,
                                _seen | {node.id})
        return False
    return False


def _const_value(node: ast.AST) -> float | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_value(node.operand)
        return None if inner is None else -inner
    return None


def _bounded(scope: _Scope, node: ast.AST, use_line: int, need: str,
             depth: int = 0) -> bool:
    """Is this expression provably bounded on one side of the arccos
    domain — ``need='lo'`` (value >= -1) or ``need='hi'`` (value <= 1)?

    Real interval reasoning, not clamp-spotting: ``maximum(x, c)`` bounds
    BELOW if either operand does but ABOVE only if both do, ``minimum``
    mirrors, and ``clip``'s literal bounds must actually sit inside
    [-1, 1] — ``clip(x, -2, 2)`` or a floor-only ``maximum(x, -1)``
    leaves the hazard live and must NOT silence it (this pass
    over-approximates hazards)."""
    if depth > _MAX_DEPTH:
        return False
    c = _const_value(node)
    if c is not None:
        return c >= -1.0 if need == "lo" else c <= 1.0
    if isinstance(node, ast.Call):
        tail, operand, rest = _call_parts(node, scope.mod.aliases)
        if tail in _BOUNDED_CALLS:
            return True
        if tail in ("clamp", "clip"):
            kws = {kw.arg: kw.value for kw in node.keywords}
            bound = kws.get("min" if need == "lo" else "max")
            if bound is None:
                pos = 0 if need == "lo" else 1
                bound = rest[pos] if len(rest) > pos else None
            bc = None if bound is None else _const_value(bound)
            return bc is not None and (
                bc >= -1.0 if need == "lo" else bc <= 1.0
            )
        if tail in ("maximum", "minimum", "fmax", "fmin") and operand is not None:
            check = any if (tail in ("maximum", "fmax")) == (need == "lo") else all
            return check(
                _bounded(scope, a, use_line, need, depth + 1)
                for a in [operand] + list(rest)
            )
        return False
    if isinstance(node, ast.Name):
        bind = scope.latest_bind(node.id, use_line)
        if bind is not None:
            return _bounded(scope, bind, getattr(bind, "lineno", use_line),
                            need, depth + 1)
    return False


def _clamp_guarded(scope: _Scope, node: ast.AST, use_line: int) -> bool:
    """arccos/arcsin domination: the input must provably sit in [-1, 1]
    on BOTH sides — a full clip/min-max sandwich with in-range literal
    bounds, or a range-bounded producer (cos/sin/tanh)."""
    return (
        _bounded(scope, node, use_line, "lo")
        and _bounded(scope, node, use_line, "hi")
    )


# --------------------------------------------------------------------------
# differentiated-scope roots

_STATIC_CALLS = {"len", "size", "numel", "prod", "dim"}
_FUNCTION_HEADS = ("torch", "math", "numpy")


def _call_parts(call: ast.Call, aliases):
    """-> (name, operand, rest): a call's trailing name, its operand (the
    first argument of a function spelling, the receiver of a Tensor-method
    spelling) and the remaining positional arguments."""
    f = call.func
    dotted = _dotted(f, aliases)
    if isinstance(f, ast.Attribute):
        tail = f.attr
        method = dotted is None or dotted.split(".")[0] not in _FUNCTION_HEADS
        if method:
            return tail, f.value, list(call.args)
    elif isinstance(f, ast.Name):
        tail = (dotted or f.id).rpartition(".")[2]
    else:
        return None, None, []
    args = list(call.args)
    return tail, (args[0] if args else None), args[1:]


def _witness_grad_roots(root: pathlib.Path, modules) -> set:
    """Roots from the gradient witnesses: every in-scope function the
    witness module names (parsed, not imported), so the differentiated set
    follows the witness set."""
    path = root / WITNESS_MODULE
    if not path.exists():
        return set()
    try:
        tree = ast.parse(path.read_text())
    except (SyntaxError, UnicodeDecodeError, OSError):
        return set()
    aliases = _alias_map(tree)
    roots = set()
    for sub in ast.walk(tree):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            d = _dotted(sub, aliases)
            resolved = None if d is None else _resolve_function(d, modules)
            if resolved:
                roots.add(resolved)
    return roots


def _registry_grad_roots(root: pathlib.Path, modules) -> set:
    """Roots from lint/registry.py: every in-scope function named by the
    build function of a ``grad=True`` Entry (parsed, not imported)."""
    path = root / REGISTRY_MODULE
    if not path.exists():
        return set()
    try:
        tree = ast.parse(path.read_text())
    except (SyntaxError, UnicodeDecodeError, OSError):
        return set()
    aliases = _alias_map(tree)
    build_fns: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and (_dotted(node.func, aliases) or "").endswith("Entry")):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        g, b = kw.get("grad"), kw.get("build")
        if not (isinstance(g, ast.Constant) and g.value is True):
            continue
        if isinstance(b, ast.Name):
            build_fns.add(b.id)
        elif isinstance(b, ast.Call) and isinstance(b.func, ast.Name):
            build_fns.add(b.func.id)
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    roots = set()
    for name in build_fns:
        for sub in ast.walk(funcs[name]) if name in funcs else ():
            if isinstance(sub, (ast.Name, ast.Attribute)):
                d = _dotted(sub, aliases)
                resolved = None if d is None else _resolve_function(d, modules)
                if resolved:
                    roots.add(resolved)
    return roots


def _autograd_methods(mod: _Module) -> list:
    """The methods of every ``torch.autograd.Function`` subclass in a
    module (its forward / backward pair and their helpers)."""
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and any(
                (_dotted(b, mod.aliases) or "").endswith("autograd.Function")
                for b in node.bases):
            out += [n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    return out


def _wrapped_roots(modules) -> set:
    """Functions handed to torch.autograd.grad / torch.func / checkpoint
    inside the scope (call site or decorator)."""
    roots = set()
    for mod in modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    _dotted(node.func, mod.aliases) not in _GRAD_WRAPPERS:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                names = [arg] if isinstance(arg, (ast.Name, ast.Attribute)) \
                    else list(ast.walk(arg.body)) if isinstance(arg, ast.Lambda) \
                    else []
                for n in names:
                    d = _dotted(n, mod.aliases) if isinstance(
                        n, (ast.Name, ast.Attribute)) else None
                    if d is None:
                        continue
                    if "." not in d and d in mod.functions:
                        roots.add((mod.dotted, d))
                    else:
                        resolved = _resolve_function(d, modules)
                        if resolved:
                            roots.add(resolved)
    return roots


def differentiated_functions(root: pathlib.Path, modules):
    """-> (reachable (module, function) keys, autograd-Function methods as
    (module, node) pairs): the scope the hazard scan covers."""
    methods = [(m, fn) for m in modules.values() for fn in _autograd_methods(m)]
    roots = (_witness_grad_roots(root, modules) | _registry_grad_roots(root, modules)
             | _wrapped_roots(modules))
    for mod, fn in methods:
        roots |= _callees(mod, fn, modules)
    return _reachable(roots, modules), methods


# --------------------------------------------------------------------------
# hazard scan

_LOG_CALLS = {"log", "log2", "log10"}
_ACOS_CALLS = {"arccos", "arcsin", "acos", "asin"}
_DIV_CALLS = {"div", "divide", "true_divide"}


def _where_branch_nodes(fn: ast.AST, aliases) -> set[int]:
    """ids of every AST node inside a branch argument of a torch.where
    call -- the R15 (VJP-trap) position."""
    out: set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        tail, operand, rest = _call_parts(node, aliases)
        if tail not in _SELECT_CALLS:
            continue
        for branch in rest[:2]:
            for sub in ast.walk(branch):
                out.add(id(sub))
    return out


def _fractional_exponent(exp) -> bool:
    """A power is a domain-edge hazard iff its exponent is fractional or
    negative (the backward has x**(p-1)); integer powers >= 1 are total.
    A non-constant exponent is not flagged (every power here is a
    literal)."""
    if isinstance(exp, ast.UnaryOp) and isinstance(exp.op, ast.USub):
        inner = exp.operand
        return isinstance(inner, ast.Constant) and \
            isinstance(inner.value, (int, float))
    if not (isinstance(exp, ast.Constant)
            and isinstance(exp.value, (int, float))):
        return False
    v = exp.value
    return v < 1 or float(v) != float(int(v))


def _scan_function(mod: _Module, fn: ast.AST, reported: set) -> list[Finding]:
    """All R14/R15 hazards in one differentiated function (full subtree:
    nested defs and lambdas inherit the differentiated scope)."""
    scope = _Scope(mod, fn)
    in_where = _where_branch_nodes(fn, mod.aliases)
    findings = []

    def add(node, kind: str, message: str) -> None:
        rule = "R15" if id(node) in in_where else "R14"
        key = (rule, mod.rel, node.lineno, getattr(node, "col_offset", 0),
               kind)
        if key in reported:
            return
        reported.add(key)
        if rule == "R15":
            message += (
                " -- and it sits inside a torch.where branch: the untaken "
                "branch's backward still runs (0 * inf = NaN poisons the "
                "whole batch gradient); guard the operand instead "
                "(utils/num.py)"
            )
        findings.append(Finding(
            rule, mod.rel, node.lineno, _line_text(mod.lines, node.lineno),
            message,
        ))

    def guarded(x, line) -> bool:
        return x is not None and _guarded(scope, x, line)

    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if not guarded(node.right, node.lineno):
                add(node, "div",
                    "division with an eps-free denominator in "
                    "differentiated scope: the backward multiplies by "
                    "1/y^2 and NaNs the batch gradient at y = 0 -- add an "
                    "eps, clamp with a constant, or select-clamp the "
                    "operand")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
            if _fractional_exponent(node.right) and \
                    not guarded(node.left, node.lineno):
                add(node, "pow",
                    "fractional/negative power of a maybe-zero base in "
                    "differentiated scope: d/dx x**p has x**(p-1), "
                    "infinite at 0 -- add an eps to the base (or use "
                    "utils.num.safe_sqrt for p = 1/2)")
        elif isinstance(node, ast.Call):
            tail, operand, rest = _call_parts(node, mod.aliases)
            if tail in _DIV_CALLS and rest:
                if not guarded(rest[0], node.lineno):
                    add(node, "div",
                        f"{tail} with an eps-free denominator in "
                        "differentiated scope -- add an eps or clamp the "
                        "denominator")
            elif tail == "reciprocal" or tail == "rsqrt":
                if not guarded(operand, node.lineno):
                    add(node, tail,
                        f"{tail} of a maybe-zero value in differentiated "
                        "scope: infinite (with its backward) at 0 -- add "
                        "an eps or clamp the operand")
            elif tail in ("pow", "float_power") and rest:
                if _fractional_exponent(rest[0]) and \
                        not guarded(operand, node.lineno):
                    add(node, "pow",
                        f"{tail} with a fractional/negative exponent of a "
                        "maybe-zero base in differentiated scope -- add an "
                        "eps to the base")
            elif tail in _ACOS_CALLS and operand is not None:
                if not _clamp_guarded(scope, operand, node.lineno):
                    add(node, "acos",
                        f"{tail} without a clamp dominating its input: the "
                        "derivative is infinite at +-1, exactly where a "
                        "converged rotation lands -- clamp the input into "
                        "[-1, 1] (or use an atan2 formulation as in "
                        "geometry/rotations.py)")
            elif tail in _LOG_CALLS and operand is not None:
                if not guarded(operand, node.lineno):
                    add(node, "log",
                        f"{tail} of a maybe-zero value in differentiated "
                        "scope: log and its backward are infinite at 0 -- "
                        "add an eps (x + 1e-12) or use log1p")
    return findings


def run_gradsafety_rules(root, files=None) -> list[Finding]:
    """All R14/R15 findings (inline suppressions applied).  Tree-global
    over the grad scope: a scoped run that touched any geometry / ransac /
    train / lint file re-analyses the whole scope (the call graph is
    cross-file); other scoped runs skip the pass."""
    if not grad_pass_needed(files):
        return []
    root = pathlib.Path(root)
    modules: dict[str, _Module] = {}
    sources: dict[str, str] = {}
    for rel in iter_python_files(root, files=None):
        if not rel.startswith(GRAD_SCOPE_PREFIXES):
            continue
        try:
            source = (root / rel).read_text()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue  # R0 is reported by the per-file pass
        m = _Module(rel, tree, source.splitlines())
        modules[m.dotted] = m
        sources[rel] = source
    if not modules:
        return []

    reachable, methods = differentiated_functions(root, modules)
    findings: list[Finding] = []
    reported: set = set()
    for mod_dotted, fname in sorted(reachable):
        mod = modules.get(mod_dotted)
        if mod is None or fname not in mod.functions:
            continue
        findings += _scan_function(mod, mod.functions[fname], reported)
    for mod, fn in methods:
        findings += _scan_function(mod, fn, reported)

    out = []
    cache: dict[str, tuple[dict, set]] = {}
    for f in findings:
        if f.path not in cache:
            cache[f.path] = parse_suppressions(sources[f.path])
        per_line, per_file = cache[f.path]
        if not is_suppressed(f.rule, f.line, per_line, per_file, path=f.path):
            out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))
