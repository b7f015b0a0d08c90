"""AST lints over ``src/repro_torch/`` (counterpart of
``repro.analysis.repolint``).

Each finding is ``file:line: rule: message``; a comment
``# repolint: allow-<rule> <reason>`` on the flagged line (or on the line
above it) exempts it — the reason is required.  The rules:

* ``host-pull`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float``/``int``/``bool`` of a non-literal, or ``torch.linalg.eigh``
  (it checks its result on the host) inside the functions a module names
  hot in its module-level ``HOT_PATHS`` tuple (``"func"`` or
  ``"Class.method"``);
* ``import-time-tensor`` — no tensor made at module scope (that would
  touch the device at import);
* ``unreferenced-cost-helper`` — every public ``*_cost`` of
  ``core/costs.py`` is named by some ``tests/test_torch_*.py``;
* ``kernel-counts`` — every function of ``kernels/ops.py`` that launches
  (calls ``_check``) counts ``LAUNCHES`` and ``PLAIN_CALLS``, and calls a
  plain version defined in ``kernels/ref.py``;
* ``kernel-error-check`` — every ``extern "C"`` entry of
  ``kernels/csrc/*.cu`` (but the ``*_max_q`` queries) returns
  ``cudaGetLastError()``, directly or through the launcher it returns;
* ``no-try-around-kernel`` — no ``try`` around a kernel build or launch
  (``load_library``, ``build_all``, ``_check``);
* ``no-jax`` — nothing imports ``jax``, ``jaxlib`` or ``repro``;
* ``span-gate`` — no ``record_function`` outside ``spans.py``, whose
  ``span`` records only while the profiler runs.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

__all__ = ["Finding", "RULES", "run_repolint", "lint_source", "PKG", "ROOT"]

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parents[1]
RULES = ("host-pull", "import-time-tensor", "unreferenced-cost-helper",
         "kernel-counts", "kernel-error-check", "no-try-around-kernel",
         "no-jax", "span-gate")
_PULL_METHODS = {"item", "tolist", "cpu", "numpy"}
_TENSOR_MAKERS = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
                  "arange", "linspace", "randn", "rand", "randint", "eye",
                  "from_numpy", "zeros_like", "ones_like", "empty_like"}
_KERNEL_CALLS = {"load_library", "build_all", "_check"}
_ALLOW = re.compile(r"#\s*repolint:\s*allow-([\w-]+)\s+\S")


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int
    rule: str
    message: str

    def text(self) -> str:
        return f"{self.file}:{self.line}: {self.rule}: {self.message}"


def _allowed(lines: list[str], line: int, rule: str,
             first: int | None = None) -> bool:
    """An allow comment for ``rule`` on ``line``, on the line above it, or
    on any line of its statement from ``first``."""
    for ln in range(min(line, first or line) - 1, line + 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW.search(lines[ln - 1])
            if m and m[1] == rule:
                return True
    return False


def _hot_paths(tree: ast.Module) -> tuple[str, ...]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "HOT_PATHS"
                for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    return ()


def _functions(tree: ast.Module):
    """``(qualified name, node)`` for module functions and methods."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _host_pulls(fn: ast.AST):
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _PULL_METHODS \
                and not node.args:
            yield node.lineno, f".{f.attr}()"
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and node.args and not isinstance(
                    node.args[0], (ast.Constant, ast.Name, ast.Attribute)):
            # a computed value (a reduction, an index, a comparison) is
            # how a tensor gets pulled; a plain name or attribute is taken
            # for a host scalar (config, clock)
            yield node.lineno, f"{f.id}() of a computed value"
        elif _dotted(f) == "torch.linalg.eigh":
            yield node.lineno, "torch.linalg.eigh (checks on the host)"


def _module_scope(tree: ast.Module):
    """Statements that run at import: the module body and class bodies,
    not function bodies."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.ClassDef):
            stack.extend(node.body)
            continue
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, (ast.FunctionDef, ast.Lambda,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef)))


def lint_source(path: Path, text: str, rel: str | None = None,
                ref_names: set[str] | None = None) -> list[Finding]:
    """The per-file rules on one Python source (``ref_names``: the
    functions of ``kernels/ref.py``, for ``kernel-counts``)."""
    rel = rel or str(path)
    tree = ast.parse(text)
    lines = text.splitlines()
    out: list[Finding] = []

    starts = {}                      # line -> first line of its statement
    for node in ast.walk(tree):
        if isinstance(node, ast.stmt) and not isinstance(
                node, (ast.FunctionDef, ast.ClassDef, ast.If, ast.For,
                       ast.While, ast.With, ast.Try)):
            for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                starts[ln] = max(starts.get(ln, 0), node.lineno)

    def add(line, rule, msg):
        if not _allowed(lines, line, rule, starts.get(line)):
            out.append(Finding(rel, line, rule, msg))

    hot = set(_hot_paths(tree))
    for name, fn in _functions(tree):
        if name in hot:
            for line, what in _host_pulls(fn):
                add(line, "host-pull", f"{what} in hot function {name}")
    for node in _module_scope(tree):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d.startswith("torch.") and d.split(".")[-1] in _TENSOR_MAKERS:
                add(node.lineno, "import-time-tensor",
                    f"{d}(...) at import time")
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names = [node.module]
        for nm in names:
            if nm.split(".")[0] in ("jax", "jaxlib", "repro"):
                add(node.lineno, "no-jax", f"imports {nm}")
        if isinstance(node, ast.Try):
            calls = {_dotted(c.func).split(".")[-1]
                     for stmt in node.body for c in ast.walk(stmt)
                     if isinstance(c, ast.Call)}
            hit = calls & _KERNEL_CALLS
            if hit:
                add(node.lineno, "no-try-around-kernel",
                    f"try around {sorted(hit)}")
    if path.parts[-2:] != ("repro_torch", "spans.py"):
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Attribute):
                names = [node.attr]
            elif isinstance(node, ast.Name):
                names = [node.id]
            elif isinstance(node, ast.ImportFrom):
                names = [a.name for a in node.names]
            if "record_function" in names:
                add(node.lineno, "span-gate",
                    "record_function outside spans.py (use spans.span)")
    if path.name == "ops.py" and path.parent.name == "kernels":
        for name, fn in _functions(tree):
            calls = {_dotted(c.func) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
            if "_check" not in calls:
                continue
            counted = {_dotted(t.value) for a in ast.walk(fn)
                       if isinstance(a, ast.AugAssign)
                       for t in [a.target] if isinstance(t, ast.Subscript)}
            missing = {"LAUNCHES", "PLAIN_CALLS"} - counted
            if missing:
                add(fn.lineno, "kernel-counts",
                    f"{name} launches but does not count {sorted(missing)}")
            plain = {a.attr for a in ast.walk(fn)
                     if isinstance(a, ast.Attribute)
                     and _dotted(a.value) == "ref"}
            if ref_names is not None and not plain & ref_names:
                add(fn.lineno, "kernel-counts",
                    f"{name} calls no plain version of kernels/ref.py")
    return out


def _strip_comments(text: str) -> str:
    """C/C++ source with its comments blanked (newlines kept)."""
    blank = lambda m: re.sub(r"[^\n]", " ", m[0])
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _c_bodies(text: str) -> dict[str, str]:
    """Function name -> body of every C/C++ function definition (comments
    stripped first)."""
    text = _strip_comments(text)
    out = {}
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\([^;{}]*\)\s*(?:const\s*)?\{",
                         text):
        if m[1] in ("if", "for", "while", "switch", "return", "sizeof"):
            continue
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out.setdefault(m[1], text[m.end():i - 1])
    return out


def _returns_error_check(name: str, bodies: dict[str, str],
                         seen: frozenset = frozenset()) -> bool:
    """The function returns ``cudaGetLastError()``, itself or through a
    launcher it returns (followed through the sources' bodies)."""
    body = bodies.get(name)
    if body is None or name in seen:
        return False
    if "cudaGetLastError()" in body:
        return True
    callees = re.findall(r"return\s+(?:\(int\)\s*)?(?:[\w:]+::)?(\w+)"
                         r"\s*(?:<[^;]*?>)?\s*\(", body)
    return any(_returns_error_check(c, bodies, seen | {name})
               for c in callees)


def lint_cuda(path: Path, text: str, rel: str,
              bodies: dict[str, str]) -> list[Finding]:
    """``kernel-error-check`` on one CUDA source (``bodies``: every
    function body of the sources, for the launchers an entry returns)."""
    lines = text.splitlines()
    code = _strip_comments(text)
    out = []
    for block in re.finditer(r'extern "C"\s*\{', code):
        depth, i = 1, block.end()
        while depth and i < len(code):
            depth += {"{": 1, "}": -1}.get(code[i], 0)
            i += 1
        for name in _c_bodies(code[block.end():i - 1]):
            if name.endswith("_max_q"):
                continue
            line = code.count("\n", 0, code.index(name, block.end())) + 1
            if not _returns_error_check(name, bodies) \
                    and not _allowed(lines, line, "kernel-error-check"):
                out.append(Finding(rel, line, "kernel-error-check",
                                   f'extern "C" {name} does not return '
                                   f"cudaGetLastError()"))
    return out


def run_repolint(pkg: Path = PKG, tests: Path | None = None
                 ) -> list[Finding]:
    """Every rule over the package (``tests``: the directory whose
    ``test_torch_*.py`` must name the cost helpers)."""
    tests = ROOT / "tests" if tests is None else tests
    base = pkg.parent
    ref_path = pkg / "kernels" / "ref.py"
    ref_names = None
    if ref_path.exists():
        body = ast.parse(ref_path.read_text()).body
        ref_names = {n.name for n in body if isinstance(n, ast.FunctionDef)}
        ref_names |= {a.asname or a.name for n in body
                      if isinstance(n, ast.ImportFrom) for a in n.names}
    out: list[Finding] = []
    for path in sorted(pkg.rglob("*.py")):
        out += lint_source(path, path.read_text(),
                           str(path.relative_to(base)), ref_names)
    cu = sorted((pkg / "kernels" / "csrc").glob("*.cu*"))
    bodies: dict[str, str] = {}
    for path in cu:
        bodies.update(_c_bodies(path.read_text()))
    for path in cu:
        if path.suffix == ".cu":
            out += lint_cuda(path, path.read_text(),
                             str(path.relative_to(base)), bodies)
    costs = pkg / "core" / "costs.py"
    if costs.exists():
        text = "\n".join(p.read_text()
                         for p in sorted(tests.glob("test_torch_*.py")))
        named = set(re.findall(r"\w+", text))
        src = costs.read_text()
        lines = src.splitlines()
        for node in ast.parse(src).body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.endswith("_cost") \
                    and not node.name.startswith("_") \
                    and node.name not in named \
                    and not _allowed(lines, node.lineno,
                                     "unreferenced-cost-helper"):
                out.append(Finding(str(costs.relative_to(base)), node.lineno,
                                   "unreferenced-cost-helper",
                                   f"{node.name} is named by no "
                                   f"tests/test_torch_*.py"))
    return out
