"""AST linter for the port's hygiene invariants (rule codes RPR0xx): the
rules of the reference's ``analysis/lint.py`` that hold for PyTorch.

========  =============================================================
RPR002    host-sync call (``.item()``, ``.tolist()``, ``.cpu()``,
          ``.numpy()``, ``np.asarray``/``np.array``/
          ``np.ascontiguousarray``, ``torch.cuda.synchronize``, or
          ``float``/``int``/``bool`` of an argument) inside code reachable
          from a body that ``runtime/graphs.py::capture`` records as a
          CUDA graph: a capture refuses a sync, and a branch that syncs
          only where the capture does not reach it hides the fault until
          the path changes.  The call graph spans module-level functions,
          methods of top-level classes (``self.foo()``/``cls.foo()``
          edges) and functions defined inside them (the captured bodies
          are such closures); methods inherited from a base class in
          another module are a blind spot, as in the reference.
RPR003    nondeterministic RNG source in library code (``src/``): the
          legacy ``np.random.*`` global state, a seedless
          ``np.random.default_rng()``, the stdlib ``random`` module, the
          global torch stream (``torch.manual_seed``, a draw such as
          ``torch.randn`` or ``x.normal_()`` without ``generator=``), or
          a ``torch.Generator`` never seeded where it is made.
========  =============================================================

The reference's RPR001 (``jnp`` dtypes under X64), RPR004 (jit-static
hashing) and RPR005 (Pallas kernel bodies) are about JAX and have no lint
rule here (``NOT_PORTED``).  RPR001's hazard, a buffer widened to 64 bits,
is checked at run time by the program audit (``analysis/audit.py``, the
counterpart of the reference's HLO audit), rule (c).

Waive an intentional finding with a trailing comment, or a comment on the
line above it alone, that gives its reason::

    n = int(lens.max())  # repro-lint: disable=RPR002  -- CPU tensors only

Findings carry the waiver state and its reason rather than being dropped;
``lint_paths`` returns every finding and the CLI fails only on unwaived
ones.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import asdict, dataclass, field

RULES = {
    "RPR002": "host-sync call inside code a CUDA graph captures",
    "RPR003": "nondeterministic RNG source in library code",
}
NOT_PORTED = {
    "RPR001": "jnp dtype widths under JAX_ENABLE_X64: its hazard, torch's hidden "
              "int64 promotion, is checked at run time by the program audit's rule "
              "(c) (python -m repro_torch.analysis --audit)",
    "RPR004": "unhashable jit-static arguments: JAX only",
    "RPR005": "Python side effects in Pallas kernel bodies: the port's kernels "
              "are CUDA C++",
}

_CAPTURE = "repro_torch.runtime.graphs.capture"
# a warm-up program's body is what ``graphs.capture_program`` captures
_PROGRAM = "repro_torch.runtime.graphs.Program"
# ``plain(name, fn, ...)`` calls a kernel's plain version ``fn``
_PLAIN = "repro_torch.kernels.common.plain"
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "ascontiguousarray"}
_SCALAR_CASTS = {"float", "int", "bool", "complex"}

# torch functions and tensor methods that draw from the global stream
# unless given generator=
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial", "poisson", "rand_like", "randn_like", "randint_like"}
_TENSOR_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                 "geometric_", "cauchy_", "log_normal_"}
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                       "torch.cuda.manual_seed_all", "torch.cuda.seed",
                       "torch.cuda.seed_all"}
_SEEDING_METHODS = {"manual_seed", "set_state"}

_WAIVER_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*|all)"
    r"(?:\s*(?:--|:)\s*(.*))?")


@dataclass
class Finding:
    """One lint hit, JSON-able via :meth:`to_dict`; ``reason`` is the text
    the waiver comment gives after ``--``."""

    path: str
    line: int
    col: int
    code: str
    message: str
    waived: bool = False
    reason: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        tag = f" (waived: {self.reason or 'no reason given'})" if self.waived else ""
        return f"{self.path}:{self.line}:{self.col}: {self.code}{tag} {self.message}"


@dataclass
class _Module:
    """Per-file facts gathered in pass 1 of the cross-module call graph."""

    path: str
    modname: str | None          # dotted repro_torch.* name, None outside src/
    tree: ast.Module
    waivers: dict[int, tuple[set[str], str]] = field(default_factory=dict)
    aliases: dict[str, str] = field(default_factory=dict)
    # module-level functions by name, methods of top-level classes as
    # "Class.method", and functions defined inside either as
    # "<owner>.<name>" (a lambda handed to capture as "<owner>.<lambda:line>")
    functions: dict[str, ast.AST] = field(default_factory=dict)
    owner_class: dict[str, str | None] = field(default_factory=dict)
    nested: dict[str, dict[str, str]] = field(default_factory=dict)
    roots: set[str] = field(default_factory=set)
    # calls made from each function: ("local", qname) or ("ext", module, name)
    calls: dict[str, set[tuple]] = field(default_factory=dict)

    @property
    def is_src(self) -> bool:
        return self.modname is not None


def _module_name(path: str) -> str | None:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if "repro_torch" not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index("repro_torch")
    if i == 0 or parts[i - 1] != "src":
        return None
    dotted = parts[i:]
    dotted[-1] = dotted[-1][:-3] if dotted[-1].endswith(".py") else dotted[-1]
    if dotted[-1] == "__init__":
        dotted = dotted[:-1]
    return ".".join(dotted)


def _collect_waivers(source: str) -> dict[int, tuple[set[str], str]]:
    waivers: dict[int, tuple[set[str], str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVER_RE.search(tok.string)
            if m:
                codes = {c.strip() for c in m.group(1).split(",")}
                # a comment on a line of its own waives the line below it
                line = tok.start[0] + (not tok.line[:tok.start[1]].strip())
                waivers[line] = (codes, (m.group(2) or "").strip())
    except tokenize.TokenError:  # an unterminated construct: no waivers past it
        pass
    return waivers


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve ``np.random.rand`` -> ``numpy.random.rand`` through imports."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _imports(mod: _Module) -> None:
    """Aliases of every import (module-level and nested: file-scoped here)."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module is not None:
            base = node.module
            if node.level:  # relative import: resolve against the package
                if not mod.modname:
                    continue
                pkg = mod.modname.split(".")[:-node.level]
                base = ".".join(pkg + [node.module])
            for a in node.names:
                mod.aliases[a.asname or a.name] = f"{base}.{a.name}"


def _functions(mod: _Module) -> None:
    """Module functions, methods, and the functions defined inside them."""
    tops: list[tuple[str, ast.AST, str | None]] = []
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            tops.append((node.name, node, None))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    tops.append((f"{node.name}.{sub.name}", sub, node.name))
    for qname, fn, cls in tops:
        mod.functions[qname] = fn
        mod.owner_class[qname] = cls
        inner = mod.nested.setdefault(qname, {})
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sub_q = f"{qname}.<{node.name}>"
                inner[node.name] = sub_q
                mod.functions[sub_q] = node
                mod.owner_class[sub_q] = cls


def _top_of(qname: str) -> str:
    """The module function or method a (possibly nested) qname lies in."""
    return qname.split(".<", 1)[0]


def _fn_ref(node: ast.AST, mod: _Module, top: str) -> str | None:
    """A function-valued expression inside ``top`` -> its qname: a function
    defined in ``top``, a module function, or a ``self.x``/``cls.x`` method
    of the owning class."""
    if isinstance(node, ast.Name):
        if node.id in mod.nested.get(top, {}):
            return mod.nested[top][node.id]
        if node.id in mod.functions:
            return node.id
    cls = mod.owner_class.get(top)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls") and cls is not None:
        qname = f"{cls}.{node.attr}"
        if qname in mod.functions:
            return qname
    return None


def _find_capture_roots(mod: _Module) -> None:
    """The bodies handed to ``graphs.capture(name, body, ...)`` and to
    ``graphs.Program(name, kind, body, ...)``."""
    for top in [q for q in mod.functions if ".<" not in q]:
        for node in ast.walk(mod.functions[top]):
            if not isinstance(node, ast.Call):
                continue
            at = {_CAPTURE: 1, _PROGRAM: 2}.get(_dotted(node.func, mod.aliases))
            if at is None:
                continue
            body = node.args[at] if len(node.args) > at else next(
                (k.value for k in node.keywords if k.arg == "body"), None)
            if isinstance(body, ast.Lambda):
                qname = f"{top}.<lambda:{body.lineno}>"
                mod.functions[qname] = body
                mod.owner_class[qname] = mod.owner_class[top]
                mod.roots.add(qname)
            elif body is not None and (qname := _fn_ref(body, mod, top)) is not None:
                mod.roots.add(qname)


def _collect_calls(mod: _Module) -> None:
    for qname, fn in mod.functions.items():
        top = _top_of(qname)
        targets: set[tuple] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func, mod.aliases) == _PLAIN and len(node.args) > 1:
                node = ast.Call(func=node.args[1], args=[], keywords=[])  # plain runs it
            local = _fn_ref(node.func, mod, top)
            if local is not None:
                targets.add(("local", local))
                continue
            dotted = _dotted(node.func, mod.aliases)
            if dotted and dotted.startswith("repro_torch."):
                module, _, func = dotted.rpartition(".")
                targets.add(("ext", module, func))
        mod.calls[qname] = targets


def _parse_module(path: str, source: str) -> _Module | None:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    mod = _Module(path=path, modname=_module_name(path), tree=tree,
                  waivers=_collect_waivers(source))
    _imports(mod)
    _functions(mod)
    _find_capture_roots(mod)
    _collect_calls(mod)
    return mod


def _captured_fixpoint(modules: dict[str, _Module]) -> set[tuple]:
    """Propagate "reachable from a captured body" across the module graph."""
    by_name = {m.modname: m for m in modules.values() if m.modname}
    reached: set[tuple] = set()
    work = [(m.path, fn) for m in modules.values() for fn in m.roots]
    while work:
        key = work.pop()
        if key in reached:
            continue
        reached.add(key)
        mod = modules[key[0]]
        for target in mod.calls.get(key[1], ()):
            if target[0] == "local":
                nxt = (mod.path, target[1])
            else:
                callee = by_name.get(target[1])
                if callee is None or target[2] not in callee.functions:
                    continue
                nxt = (callee.path, target[2])
            if nxt not in reached:
                work.append(nxt)
    return reached


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _rule_rpr002(mod: _Module, reached: set[tuple], out: list[Finding]) -> None:
    for fname, fn in mod.functions.items():
        if (mod.path, fname) not in reached:
            continue
        args = fn.args
        params = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs} - \
            {"self", "cls"}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_SYNC_METHODS:
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "RPR002",
                    f".{node.func.attr}() reads the device from the host inside "
                    f"captured '{fname}'"))
                continue
            dotted = _dotted(node.func, mod.aliases)
            if dotted == "torch.cuda.synchronize" or (
                    dotted and dotted.startswith("numpy.")
                    and dotted.rsplit(".", 1)[1] in _NP_SYNC_FUNCS):
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "RPR002",
                    f"{dotted} waits for the device inside captured '{fname}'"))
            elif isinstance(node.func, ast.Name) and node.func.id in _SCALAR_CASTS \
                    and len(node.args) == 1 and not node.keywords \
                    and isinstance(node.args[0], ast.Name) and node.args[0].id in params:
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "RPR002",
                    f"{node.func.id}({node.args[0].id}) of an operand of captured "
                    f"'{fname}' reads it on the host"))


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    return {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}


def _seeded_later(gen: ast.Call, parents: dict, mod: _Module) -> bool:
    """Is a ``torch.Generator(...)`` seeded where it is made: chained with
    ``.manual_seed``/``.set_state``, or bound to a name that the enclosing
    function (or the module) seeds."""
    parent = parents.get(gen)
    if isinstance(parent, ast.Attribute) and parent.attr in _SEEDING_METHODS:
        return True
    if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        return False
    name = parent.targets[0].id
    scope = parent
    while scope in parents and not isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        scope = parents[scope]
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in _SEEDING_METHODS
               and isinstance(n.func.value, ast.Name) and n.func.value.id == name
               for n in ast.walk(scope))


def _rule_rpr003(mod: _Module, out: list[Finding]) -> None:
    if not mod.is_src:
        return
    parents = _parents(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, mod.aliases)
        kwargs = {k.arg for k in node.keywords}
        msg = None
        if dotted is None:
            pass
        elif dotted.startswith("numpy.random."):
            fn = dotted.split(".")[-1]
            if fn == "default_rng" and not (node.args or node.keywords):
                msg = f"{dotted}() without a seed draws a fresh stream every run"
            elif fn not in ("default_rng", "Generator", "SeedSequence"):
                msg = f"{dotted}: numpy's global-state RNG in library code"
        elif dotted.startswith("random.") and \
                mod.aliases.get("random", "random") == "random" and \
                "random" not in mod.functions:
            msg = f"stdlib {dotted}: the process-global RNG in library code"
        elif dotted in _TORCH_GLOBAL_SEEDS:
            msg = f"{dotted}: seeds torch's process-global stream"
        elif dotted.startswith("torch.") and dotted.rsplit(".", 1)[1] in _TORCH_DRAWS \
                and dotted.count(".") == 1 and "generator" not in kwargs:
            msg = f"{dotted} without generator= draws from torch's global stream"
        elif dotted == "torch.Generator" and not _seeded_later(node, parents, mod):
            msg = "torch.Generator never seeded where it is made"
        if msg is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TENSOR_DRAWS and "generator" not in kwargs and \
                not (dotted or "").startswith("numpy."):
            msg = f".{node.func.attr}() without generator= draws from torch's global stream"
        if msg is not None:
            out.append(Finding(mod.path, node.lineno, node.col_offset, "RPR003", msg))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def iter_py_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(files))


def lint_paths(paths: list[str]) -> list[Finding]:
    """Lint every ``.py`` under *paths*; returns all findings (waived ones
    are marked, with their reason, not dropped)."""
    modules: dict[str, _Module] = {}
    for f in iter_py_files(paths):
        with open(f, encoding="utf-8") as fh:
            source = fh.read()
        mod = _parse_module(f, source)
        if mod is not None:
            modules[f] = mod

    reached = _captured_fixpoint(modules)
    findings: list[Finding] = []
    for mod in modules.values():
        out: list[Finding] = []
        _rule_rpr002(mod, reached, out)
        _rule_rpr003(mod, out)
        for f in out:
            codes, reason = mod.waivers.get(f.line, (set(), ""))
            if "all" in codes or f.code in codes:
                f.waived, f.reason = True, reason
        findings.extend(out)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings
