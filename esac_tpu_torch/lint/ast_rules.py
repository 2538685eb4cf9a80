"""Static layer: AST rules R1-R6, R8 and R11 over the port's Python sources
(counterpart of ``esac_tpu/lint/ast_rules.py``).

Pure ``ast`` -- no torch import, no execution.  Each rule is scoped by
repo-relative path; inline ``# torch-lint: disable=RULE(reason)``
suppressions are honored here, while the committed baseline is applied by
the caller (:mod:`esac_tpu_torch.lint.cli`).

The port forms of the rules (``findings.RULES`` carries the texts):

- R1: CUDA initialised at import;
- R2: raw norm / bare sqrt in differentiated code;
- R3: iterative linalg reachable from a main-path entry point, through a
  lightweight intra-package call graph (over-approximates callees, does
  not resolve method calls through instances);
- R4: unpinned products in the precision-pinned modules;
- R5: config dataclasses frozen;
- R6: quiet device choice outside ``resolve_device``;
- R8: a staged (pooled pinned) buffer or a ``non_blocking=True`` copy's
  source rewritten before a fence;
- R11: every public entry point is registered in ``lint/registry.py`` (the
  graph audit's entries) or waived there with its reason.
"""

from __future__ import annotations

import ast
import pathlib

from esac_tpu_torch.lint.findings import Finding
from esac_tpu_torch.lint.suppress import is_suppressed, parse_suppressions

PACKAGE = "esac_tpu_torch"
# The port's files outside the package that the lint covers.
ROOT_SCRIPTS = ("chip_smoke.py",)

_SKIP_DIRS = {".git", "__pycache__", ".venv", "build", "ckpts", "node_modules"}

# Tensor factories that take a device= (R1).
_FACTORIES = {
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
    "zeros_like", "ones_like", "empty_like", "full_like", "from_numpy",
    "Generator",
}

# Iterative linalg (R3): torch.linalg tails, and torch.* spellings.
_LINALG_TAILS = {"svd", "svdvals", "solve", "solve_ex", "inv", "inv_ex",
                 "pinv", "eig", "eigh", "eigvals", "eigvalsh", "lstsq",
                 "matrix_power", "slogdet", "det"}
_LINALG_PREFIXES = ("lu", "cholesky")
_TORCH_LINALG = {"torch.inverse", "torch.svd", "torch.pinverse",
                 "torch.cholesky", "torch.cholesky_solve",
                 "torch.cholesky_inverse", "torch.lu", "torch.lu_solve",
                 "torch.det", "torch.logdet", "torch.slogdet"}
# Main-path entry points (R3 roots), by name prefix.
_R3_ROOT_PREFIXES = ("dsac_infer", "esac_infer", "dsac_train_loss",
                     "esac_train_loss")

# Unpinned contractions (R4): torch functions and Tensor methods.
_CONTRACTIONS = {"torch.matmul", "torch.mm", "torch.bmm", "torch.einsum",
                 "torch.tensordot", "torch.nn.functional.linear",
                 "torch.addmm", "torch.baddbmm", "torch.mv", "torch.dot",
                 "torch.chain_matmul", "torch.linalg.multi_dot"}
_CONTRACTION_METHODS = {"matmul", "mm", "bmm", "mv"}

# In-place writes of a tensor (R8): Tensor methods ending in "_" that
# write their receiver.
_INPLACE_WRITES = {"copy_", "fill_", "zero_", "add_", "sub_", "mul_",
                   "div_", "clamp_", "index_copy_", "index_fill_",
                   "masked_fill_", "scatter_", "put_", "normal_",
                   "uniform_", "random_"}


def iter_python_files(root: pathlib.Path, files=None):
    """Repo-relative posix paths of the .py files to lint: the package and
    the port's root scripts (``files`` narrows to those given)."""
    root = pathlib.Path(root)
    if files is not None:
        for f in files:
            rel = pathlib.Path(f)
            if rel.is_absolute():
                rel = rel.relative_to(root)
            if rel.suffix == ".py" and (root / rel).exists():
                yield rel.as_posix()
        return
    for name in ROOT_SCRIPTS:
        if (root / name).exists():
            yield name
    pkg = root / PACKAGE
    if not pkg.is_dir():
        return
    for p in sorted(pkg.rglob("*.py")):
        rel = p.relative_to(root)
        if any(part in _SKIP_DIRS for part in rel.parts):
            continue
        yield rel.as_posix()


def _alias_map(tree: ast.AST) -> dict[str, str]:
    """Name bound by an import -> fully dotted target, whole file."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve an expression to a dotted name with import aliases expanded
    (``F.linear`` -> ``torch.nn.functional.linear`` under ``import
    torch.nn.functional as F``); None for non-name expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    head = aliases.get(parts[0], parts[0])
    return ".".join([head] + parts[1:])


def _walk_no_functions(node: ast.AST):
    """ast.walk that does not descend into function/lambda bodies (but does
    visit their decorators and default-argument expressions, which execute
    at import time)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(n.decorator_list)
            stack.extend(n.args.defaults)
            stack.extend(d for d in n.args.kw_defaults if d is not None)
            continue
        if isinstance(n, ast.Lambda):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _line_text(lines: list[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


# --------------------------------------------------------------------------
# rule scopes (repo-relative posix paths)

def _in_package(rel: str, *subdirs: str) -> bool:
    if not subdirs:
        return rel.startswith(PACKAGE + "/")
    return rel.startswith(tuple(f"{PACKAGE}/{d}" for d in subdirs))


def _r1_scope(rel: str) -> bool:
    return _in_package(rel) or rel in ROOT_SCRIPTS


def _r2_scope(rel: str) -> bool:
    return _in_package(rel, "geometry/", "ransac/", "train/")


def _r4_scope(rel: str) -> bool:
    return _in_package(rel, "geometry/") or rel in {
        f"{PACKAGE}/ransac/{m}.py"
        for m in ("refine", "scoring", "sampling", "kernel", "esac")
    }


def _r5_scope(rel: str) -> bool:
    return _in_package(rel)


def _r6_scope(rel: str) -> bool:
    return _in_package(rel) or rel in ROOT_SCRIPTS


def _r3_scope(rel: str) -> bool:
    return _in_package(rel)


def _r8_scope(rel: str) -> bool:
    return _in_package(rel, "serve/", "registry/", "fleet/", "parallel/")


# --------------------------------------------------------------------------
# R1: CUDA at import

def _is_cuda_device(node: ast.AST, aliases) -> bool:
    """A literal CUDA device: ``"cuda"``, ``"cuda:1"``, or
    ``torch.device("cuda"...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and _dotted(node.func, aliases) == "torch.device":
        return bool(node.args) and _is_cuda_device(node.args[0], aliases)
    return False


def _device_kw(call: ast.Call):
    return next((kw.value for kw in call.keywords if kw.arg == "device"), None)


def _rule_r1(rel, tree, aliases, lines):
    out = []
    for node in _walk_no_functions(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, aliases) or ""
        what = None
        if dotted.startswith("torch.cuda."):
            what = dotted
        elif dotted.startswith("torch.") and \
                dotted.rpartition(".")[2] in _FACTORIES:
            dev = _device_kw(node)
            if dev is not None and _is_cuda_device(dev, aliases):
                what = f"{dotted}(device=cuda)"
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr == "cuda":
                what = ".cuda()"
            elif node.func.attr == "to":
                dev = _device_kw(node) or (node.args[0] if node.args else None)
                if dev is not None and _is_cuda_device(dev, aliases):
                    what = ".to(cuda)"
        if what is not None:
            out.append(Finding(
                "R1", rel, node.lineno, _line_text(lines, node.lineno),
                f"module-level {what} initialises CUDA at import: forked "
                "workers then inherit a context they cannot use, and "
                "importing needs a card; build it inside a function",
            ))
    return out


# --------------------------------------------------------------------------
# R2: raw norm / bare sqrt

def _eps_guarded(arg: ast.AST) -> bool:
    """True for ``x + eps``-shaped sqrt arguments (eps inside the sqrt)."""
    if not (isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add)):
        return False
    for side in (arg.left, arg.right):
        if isinstance(side, ast.Constant) and isinstance(side.value, (int, float)):
            return True
        name = None
        if isinstance(side, ast.Name):
            name = side.id
        elif isinstance(side, ast.Attribute):
            name = side.attr
        if name is not None and "eps" in name.lower():
            return True
    return False


def _rule_r2(rel, tree, aliases, lines):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, aliases)
        tensor_norm = isinstance(node.func, ast.Attribute) and \
            node.func.attr == "norm" and \
            not (dotted or "").startswith(("torch.", "numpy.", "math."))
        if tensor_norm or dotted in ("torch.linalg.norm",
                                     "torch.linalg.vector_norm", "torch.norm"):
            out.append(Finding(
                "R2", rel, node.lineno, _line_text(lines, node.lineno),
                "raw norm in differentiated geometry NaNs the backward at "
                "zero input; use utils.num.safe_norm",
            ))
        elif dotted == "torch.sqrt":
            if node.args and _eps_guarded(node.args[0]):
                continue
            out.append(Finding(
                "R2", rel, node.lineno, _line_text(lines, node.lineno),
                "bare torch.sqrt has an infinite backward at 0; use "
                "utils.num.safe_sqrt or put an eps inside the sqrt",
            ))
    return out


# --------------------------------------------------------------------------
# R4: unpinned products

def _rule_r4(rel, tree, aliases, lines):
    out = []
    for node in ast.walk(tree):
        what = None
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            what = "@"
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func, aliases)
            if dotted in _CONTRACTIONS:
                what = dotted
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _CONTRACTION_METHODS and \
                    not (dotted or "").startswith("torch."):
                what = f"Tensor.{node.func.attr}"
        if what is not None:
            out.append(Finding(
                "R4", rel, node.lineno, _line_text(lines, node.lineno),
                f"{what} in a precision-pinned module: cuBLAS splits a "
                "product by the call's size and breaks the frame-bucket "
                "contract; use utils.precision.hmm / fixed_sum",
            ))
    return out


# --------------------------------------------------------------------------
# R5: frozen configs

def _rule_r5(rel, tree, aliases, lines):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or not node.name.endswith("Config"):
            continue
        for dec in node.decorator_list:
            call = dec if isinstance(dec, ast.Call) else None
            target = dec.func if call is not None else dec
            dotted = _dotted(target, aliases)
            if dotted is None or not dotted.endswith("dataclass"):
                continue
            frozen = call is not None and any(
                kw.arg == "frozen"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in call.keywords
            )
            if not frozen:
                out.append(Finding(
                    "R5", rel, node.lineno, _line_text(lines, node.lineno),
                    f"config dataclass {node.name} must be frozen=True to "
                    "be hashable and safe to share across threads",
                ))
    return out


# --------------------------------------------------------------------------
# R6: quiet device choice

def _raise_only(body: list) -> bool:
    return len(body) == 1 and isinstance(body[0], ast.Raise)


def _rule_r6(rel, tree, aliases, lines):
    # Calls inside resolve_device are the sanctioned choice; a call that
    # is the test of an `if` whose only statement raises (and no else) is
    # a loud failure, not a choice.
    exempt: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == "resolve_device":
            exempt.update(id(n) for n in ast.walk(node))
        elif isinstance(node, ast.If) and _raise_only(node.body) and \
                not node.orelse:
            exempt.update(id(n) for n in ast.walk(node.test))
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or id(node) in exempt:
            continue
        if _dotted(node.func, aliases) != "torch.cuda.is_available":
            continue
        out.append(Finding(
            "R6", rel, node.lineno, _line_text(lines, node.lineno),
            "torch.cuda.is_available() picks a device or a code path "
            "outside utils.precision.resolve_device: an entry point runs on "
            "the card unless the caller asks for the CPU, and never falls "
            "back quietly (a reviewed site carries an inline suppression "
            "with its reason)",
        ))
    return out


# --------------------------------------------------------------------------
# R8: staging buffers written before the fence

def _linear_events(body, aliases, fencing: set[str], staging: dict[str, str]):
    """The R8 events of a statement list in execution order: loop bodies
    ``STAGING_DEPTH + 1`` times (the next iterations follow), both
    branches of an ``if`` in turn, nested function bodies skipped (their
    own scope).  Events are ("stage", line, owner), ("copy", line, name),
    ("write", line, name) and ("fence", line, None).  A call of a local
    function that stages (``staging``: name -> owner) is a stage event."""
    events = []

    def call_events(node):
        out = []
        for sub in _walk_calls(node):
            f = sub.func
            if not isinstance(f, ast.Attribute):
                if isinstance(f, ast.Name) and f.id in fencing:
                    out.append(("fence", sub.lineno, None))
                elif isinstance(f, ast.Name) and f.id in staging:
                    out.append(("stage", sub.lineno, staging[f.id]))
                continue
            if f.attr == "synchronize" or f.attr in fencing:
                out.append(("fence", sub.lineno, None))
            elif f.attr == "stage":
                out.append(("stage", sub.lineno,
                            _dotted(f.value, aliases) or "?"))
            elif f.attr in staging:
                out.append(("stage", sub.lineno, staging[f.attr]))
            elif f.attr in ("to", "copy_") and any(
                    kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in sub.keywords):
                src = f.value if f.attr == "to" else (
                    sub.args[0] if sub.args else None)
                if isinstance(src, ast.Name):
                    out.append(("copy", sub.lineno, src.id))
            if f.attr in _INPLACE_WRITES and isinstance(f.value, ast.Name):
                out.append(("write", sub.lineno, f.value.id))
        return out

    def stores(node):
        out = []
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Subscript) and \
                        isinstance(sub.value, ast.Name):
                    out.append(("write", sub.lineno, sub.value.id))
        return out

    def walk(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                events.extend(call_events(st.iter if isinstance(
                    st, (ast.For, ast.AsyncFor)) else st.test))
                for _ in range(STAGING_DEPTH + 1):
                    walk(st.body)
                walk(st.orelse)
            elif isinstance(st, ast.If):
                events.extend(call_events(st.test))
                walk(st.body)
                walk(st.orelse)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    events.extend(call_events(item.context_expr))
                walk(st.body)
            elif isinstance(st, ast.Try):
                walk(st.body)
                for h in st.handlers:
                    walk(h.body)
                walk(st.orelse)
                walk(st.finalbody)
            else:
                # Calls first (the right-hand side runs before the store).
                events.extend(call_events(st))
                events.extend(stores(st))

    walk(body)
    return events


def _walk_calls(node):
    """Calls in ``node`` in source order, not inside nested scopes."""
    found = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            found.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return sorted(found, key=lambda c: (c.lineno, c.col_offset))


def _helper_names(tree, aliases):
    """Functions and methods of the file whose body synchronizes (a call of
    one is a fence: the ``self._wait(d)`` idiom), and those whose body
    stages (name -> the staging owner: the dispatcher's ``_stage`` and the
    ``stage(lo, hi)`` closure of ``infer_many`` that calls it), followed
    through calls of the file's own functions and methods.  A helper that
    does both counts as a fence."""
    fencing, staging = set(), {}
    funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    grown = True
    while grown:
        grown = False
        for node in funcs:
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if node.name not in fencing and (name == "synchronize" or name in fencing):
                    fencing.add(node.name)
                    grown = True
                elif node.name not in staging and isinstance(f, ast.Attribute) \
                        and name == "stage":
                    staging[node.name] = _dotted(f.value, aliases) or "?"
                    grown = True
                elif node.name not in staging and name in staging:
                    staging[node.name] = staging[name]
                    grown = True
    return fencing, staging


# Pooled staging keeps this many buffers per key (StagingCache's default
# depth): one staging may be in flight while the next is written, and a
# buffer is rewritten STAGING_DEPTH stagings after it was last written.
STAGING_DEPTH = 2


def _rule_r8(rel, tree, aliases, lines):
    fencing, staging = _helper_names(tree, aliases)
    bodies = [tree.body] + [
        n.body for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    out = []
    seen: set[tuple[int, str]] = set()
    for body in bodies:
        in_flight_stages: dict[str, int] = {}
        in_flight_sources: dict[str, int] = {}
        for kind, line, name in _linear_events(body, aliases, fencing, staging):
            if kind == "fence":
                in_flight_stages.clear()
                in_flight_sources.clear()
            elif kind == "stage":
                n = in_flight_stages.get(name, 0)
                if n >= STAGING_DEPTH and (line, "stage") not in seen:
                    seen.add((line, "stage"))
                    out.append(Finding(
                        "R8", rel, line, _line_text(lines, line),
                        f"{name}.stage(...) rewrites a pooled staging "
                        f"buffer while {n} earlier staging(s) from the same "
                        "pool are unfenced: the asynchronous copy of the "
                        "in-flight dispatch may still read it -- "
                        "synchronize the dispatch's Event first",
                    ))
                in_flight_stages[name] = n + 1
            elif kind == "copy":
                in_flight_sources[name] = line
            elif kind == "write" and name in in_flight_sources:
                if (line, name) in seen:
                    continue
                seen.add((line, name))
                out.append(Finding(
                    "R8", rel, line, _line_text(lines, line),
                    f"'{name}' is written while its non_blocking copy (line "
                    f"{in_flight_sources[name]}) may still be reading it: "
                    "fence the copy (Event.synchronize / "
                    "torch.cuda.synchronize) before rewriting the source",
                ))
    return out


# --------------------------------------------------------------------------
# R3: package-wide call graph

class _Module:
    def __init__(self, rel: str, tree: ast.AST, lines: list[str]):
        self.rel = rel
        self.tree = tree
        self.lines = lines
        self.aliases = _alias_map(tree)
        # "esac_tpu_torch/geometry/pnp.py" -> "esac_tpu_torch.geometry.pnp"
        self.dotted = rel[:-3].replace("/", ".")
        if self.dotted.endswith(".__init__"):
            self.dotted = self.dotted[: -len(".__init__")]
        self.functions: dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)


def _resolve_function(dotted: str, modules: dict[str, "_Module"], _depth=0):
    """Dotted callable name -> (module, funcname) inside the package,
    following package-``__init__`` re-exports."""
    if not dotted.startswith(PACKAGE + ".") or _depth > 4:
        return None
    mod_path, _, func = dotted.rpartition(".")
    m = modules.get(mod_path)
    if m is None:
        return None
    if func in m.functions:
        return (mod_path, func)
    target = m.aliases.get(func)
    if target is not None and target != dotted:
        return _resolve_function(target, modules, _depth + 1)
    return None


def _callees(
    mod: _Module, body: ast.AST, modules: dict[str, "_Module"]
) -> set[tuple[str, str]]:
    out = set()
    for node in ast.walk(body):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, mod.aliases)
        if dotted is None:
            continue
        if "." not in dotted and dotted in mod.functions:
            out.add((mod.dotted, dotted))
            continue
        resolved = _resolve_function(dotted, modules)
        if resolved:
            out.add(resolved)
    return out


def _reachable(roots, modules) -> set[tuple[str, str]]:
    reachable: set[tuple[str, str]] = set()
    frontier = list(roots)
    while frontier:
        key = frontier.pop()
        if key in reachable:
            continue
        reachable.add(key)
        mod = modules.get(key[0])
        if mod is None:
            continue
        fn = mod.functions.get(key[1])
        if fn is None:
            continue
        frontier.extend(_callees(mod, fn, modules))
    return reachable


def _r3_roots(modules: dict[str, _Module]) -> set[tuple[str, str]]:
    return {
        (mod.dotted, name)
        for mod in modules.values()
        for name in mod.functions
        if name.startswith(_R3_ROOT_PREFIXES)
    }


def _iterative_linalg(dotted: str) -> bool:
    if dotted in _TORCH_LINALG:
        return True
    if not dotted.startswith("torch.linalg."):
        return False
    tail = dotted.rpartition(".")[2]
    return tail in _LINALG_TAILS or tail.startswith(_LINALG_PREFIXES)


def _rule_r3(modules: dict[str, _Module]):
    out = []
    for mod_dotted, func in sorted(_reachable(_r3_roots(modules), modules)):
        mod = modules[mod_dotted]
        fn = mod.functions[func]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, mod.aliases)
            if dotted is None or not _iterative_linalg(dotted):
                continue
            out.append(Finding(
                "R3", mod.rel, node.lineno,
                _line_text(mod.lines, node.lineno),
                f"{dotted} inside {func}(), which a main-path entry point "
                "reaches: the library solver picks its algorithm by batch "
                "size and syncs on its error checks -- use the triad / "
                "unrolled patterns of geometry/pnp.py",
            ))
    return out


# --------------------------------------------------------------------------
# R11: the traced registry's coverage

REGISTRY = f"{PACKAGE}/lint/registry.py"
# Where the port's compiled-surface counterparts live, and the names that
# make a public function one: the JAX package's jitted entry points and
# make_* factories, by their port names.
_R11_DIRS = ("geometry/", "ransac/", "parallel/", "registry/", "retrieval/",
             "serve/", "train/")
_R11_PREFIXES = ("dsac_infer", "esac_infer", "dsac_train_loss", "esac_train_loss",
                 "solve_pnp", "refine_", "sample_correspondence", "soft_inlier_score")


def _r11_discover(root: pathlib.Path):
    """Public entry points package-wide: ``[(rel, lineno, name)]`` -- a
    public top-level function named as a main-path entry (the prefixes
    above), or a public ``make_*`` factory that defines the function it
    returns."""
    out = []
    for rel in iter_python_files(root):
        if not _in_package(rel, *_R11_DIRS):
            continue
        try:
            tree = ast.parse((root / rel).read_text(), filename=rel)
        except (SyntaxError, UnicodeDecodeError):
            continue  # R0 comes from the per-file pass
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef) or node.name.startswith("_"):
                continue
            factory = node.name.startswith("make_") and any(
                isinstance(sub, (ast.FunctionDef, ast.Lambda)) and sub is not node
                for sub in ast.walk(node))
            if factory or node.name.startswith(_R11_PREFIXES):
                out.append((rel, node.lineno, node.name))
    return out


def _r11_registry_names(source: str) -> tuple[set[str], dict[str, str]]:
    """-> (identifiers the registry references, its R11_WAIVED map)."""
    tree = ast.parse(source)
    names: set[str] = set()
    waived: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.name for a in node.names)
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == "R11_WAIVED" for t in targets) \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    try:
                        waived[k.value] = ast.literal_eval(v)
                    except ValueError:
                        waived[k.value] = ""
    return names, waived


def run_registry_coverage(root, files=None) -> list[Finding]:
    """R11 over the whole package (tree-global whenever a package file is in
    scope): every discovered entry point is registered or waived."""
    root = pathlib.Path(root)
    registry = root / REGISTRY
    if not registry.exists():
        return []  # not an audited tree
    if files is not None and not any(
            f.startswith(PACKAGE + "/") and f.endswith(".py") for f in files):
        return []
    registered, waived = _r11_registry_names(registry.read_text())
    findings = []
    for rel, lineno, name in _r11_discover(root):
        if name in registered or name in waived:
            continue
        source = (root / rel).read_text()
        per_line, per_file = parse_suppressions(source)
        if is_suppressed("R11", lineno, per_line, per_file, path=rel):
            continue
        findings.append(Finding(
            "R11", rel, lineno, _line_text(source.splitlines(), lineno),
            f"public entry point '{name}' is neither registered in {REGISTRY} nor "
            "waived in its R11_WAIVED: every compiled surface rides the graph audit "
            "and the ledger (add an Entry, or a waiver with a reviewed reason)"))
    return findings


def stale_r11_waivers(root) -> list[str]:
    """Notes for waivers that name no discovered entry point."""
    root = pathlib.Path(root)
    registry = root / REGISTRY
    if not registry.exists():
        return []
    _, waived = _r11_registry_names(registry.read_text())
    discovered = {name for _, _, name in _r11_discover(root)}
    return [f"stale R11 waiver '{name}': no public entry point of that name is "
            f"discovered any more -- prune it from R11_WAIVED ({REGISTRY})"
            for name in sorted(waived) if name not in discovered]


# --------------------------------------------------------------------------
# the pass over the tree

def run_python_rules(root, files=None) -> list[Finding]:
    root = pathlib.Path(root)
    findings: list[Finding] = []
    r3_modules: dict[str, _Module] = {}
    suppressions: dict[str, tuple[dict, set]] = {}

    for rel in iter_python_files(root, files):
        if rel.startswith("tests/"):
            continue
        try:
            source = (root / rel).read_text()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                "R0", rel, getattr(e, "lineno", 0) or 0, "",
                f"unparsable python: {e}",
            ))
            continue
        lines = source.splitlines()
        aliases = _alias_map(tree)
        suppressions[rel] = parse_suppressions(source)

        for scope, rule in ((_r1_scope, _rule_r1), (_r2_scope, _rule_r2),
                            (_r4_scope, _rule_r4), (_r5_scope, _rule_r5),
                            (_r6_scope, _rule_r6), (_r8_scope, _rule_r8)):
            if scope(rel):
                findings += rule(rel, tree, aliases, lines)
        if _r3_scope(rel):
            m = _Module(rel, tree, lines)
            r3_modules[m.dotted] = m

    if r3_modules:
        # R3 needs every package module for its call graph; a scoped run
        # parses the rest of the package to build it.
        if files is not None:
            for rel in iter_python_files(root):
                if _r3_scope(rel) and rel[:-3].replace("/", ".") not in r3_modules:
                    try:
                        source = (root / rel).read_text()
                        m = _Module(rel, ast.parse(source), source.splitlines())
                    except (SyntaxError, UnicodeDecodeError):
                        continue
                    r3_modules[m.dotted] = m
                    suppressions.setdefault(rel, parse_suppressions(source))
        scoped = None if files is None else set(files)
        findings += [f for f in _rule_r3(r3_modules)
                     if scoped is None or f.path in scoped]

    out = []
    for f in findings:
        per_line, per_file = suppressions.get(f.path, ({}, set()))
        if not is_suppressed(f.rule, f.line, per_line, per_file,
                             path=f.path):
            out.append(f)
    return out
