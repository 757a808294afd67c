"""Convention lint pass: AST checks for the port's rules that no linter
expresses, each with the reference's waiver syntax (``# contract:
allow-<rule>`` on the offending line or in the comment block just above
it -- a reviewed, documented exception, not a hole):

* raw-collective: calls into ``torch.distributed``'s collective and
  point-to-point functions only in ``repro_torch/core/engine.py`` (``Comm``,
  the solvers' one communication point) and ``repro_torch/core/world.py``
  (the world's set-up).  Anything else routes through ``Comm`` or carries
  an ``allow-collective`` waiver.
* operand-transpose: inside classes that implement the formulation hooks
  (``bind`` / ``bind_shard`` / ``packet_vector`` / ``update`` /
  ``inner_sweep`` / ``init_carry`` / ``metrics``), no ``.T``, ``.mT``,
  ``.t()`` or ``.transpose(...)``: operands bind in X's original layout and
  the operand's gather owns every transposition.  The warm start's and the
  metrics' products carry ``allow-transpose`` waivers.
* foreign-import: no import of ``jax`` or of the reference package
  ``repro`` in the port (the port stands alone; the reference's third rule,
  XLA_FLAGS before jax, has no torch meaning).

Standard library only: ``python -m repro_torch.analysis lint`` runs as a
pre-commit hook.
"""
from __future__ import annotations

import ast
import os

from .report import PassReport, Violation

COLLECTIVE_CALLS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_to_all", "all_to_all_single", "barrier", "batch_isend_irecv",
    "broadcast", "broadcast_object_list", "gather", "irecv", "isend", "recv",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter", "send"})
# Files where raw collectives ARE the design (path suffixes, POSIX form).
COLLECTIVE_ALLOWLIST = ("repro_torch/core/engine.py",
                        "repro_torch/core/world.py")
FORMULATION_HOOKS = frozenset({
    "bind", "bind_shard", "packet_vector", "update", "inner_sweep",
    "init_carry", "metrics"})
TRANSPOSE_ATTRS = frozenset({"T", "mT"})
TRANSPOSE_CALLS = frozenset({"t", "transpose"})
FOREIGN_PACKAGES = ("jax", "jaxlib", "repro")
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py")


def _waived(lines: list, lineno: int, rule: str) -> bool:
    """Waiver on the offending line, or anywhere in the contiguous comment
    block immediately above it."""
    tag = f"contract: allow-{rule}"
    if 1 <= lineno <= len(lines) and tag in lines[lineno - 1]:
        return True
    ln = lineno - 1
    while 1 <= ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"):
        if tag in lines[ln - 1]:
            return True
        ln -= 1
    return False


def _attr_chain(node) -> list:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _dist_names(tree) -> tuple[set, set]:
    """(names bound to the torch.distributed module, names bound to one of
    its collective functions) by this file's imports."""
    modules, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                modules.update(a.asname or a.name for a in node.names
                               if a.name == "distributed")
            elif node.module == "torch.distributed":
                funcs.update(a.asname or a.name for a in node.names
                             if a.name in COLLECTIVE_CALLS)
    return modules, funcs


def _collective_call(call: ast.Call, modules: set, funcs: set) -> str | None:
    chain = _attr_chain(call.func)
    if not chain:
        return None
    if len(chain) == 1:
        return chain[0] if chain[0] in funcs else None
    if chain[-1] not in COLLECTIVE_CALLS:
        return None
    head = chain[:-1]
    if head[-2:] == ["torch", "distributed"] or head[-1] in modules:
        return ".".join(chain)
    return None


def _check_collectives(tree, lines, relpath, violations):
    if relpath.replace(os.sep, "/").endswith(COLLECTIVE_ALLOWLIST):
        return
    modules, funcs = _dist_names(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _collective_call(node, modules, funcs)
        if name and not _waived(lines, node.lineno, "collective"):
            violations.append(Violation(
                "raw-collective", f"{relpath}:{node.lineno}",
                f"raw {name} call outside core/engine.py's Comm -- route "
                "the reduction through Comm, or waive with "
                "'# contract: allow-collective'"))


def _transpose_at(node) -> str | None:
    if isinstance(node, ast.Attribute) and node.attr in TRANSPOSE_ATTRS:
        return f".{node.attr}"
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in TRANSPOSE_CALLS):
        return f".{node.func.attr}()"
    return None


def _check_transposes(tree, lines, relpath, violations):
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name for n in cls.body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if not methods & FORMULATION_HOOKS:
            continue
        for node in ast.walk(cls):
            what = _transpose_at(node)
            if what and not _waived(lines, node.lineno, "transpose"):
                violations.append(Violation(
                    "operand-transpose", f"{relpath}:{node.lineno}",
                    f"'{what}' inside formulation class {cls.name} -- "
                    "operands bind in X's original layout (the operand's "
                    "gather owns transposition); waive with "
                    "'# contract: allow-transpose'"))


def _foreign(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in FOREIGN_PACKAGES)


def _check_imports(tree, lines, relpath, violations):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if _foreign(name) and not _waived(lines, node.lineno, "import"):
                violations.append(Violation(
                    "foreign-import", f"{relpath}:{node.lineno}",
                    f"import of {name!r}: the port imports neither jax nor "
                    "the reference package"))


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_file(path: str, repo_root: str | None = None) -> list:
    relpath = os.path.relpath(path, repo_root) if repo_root else path
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation("parse-error", f"{relpath}:{e.lineno}", str(e))]
    lines = src.splitlines()
    violations: list = []
    _check_collectives(tree, lines, relpath, violations)
    _check_transposes(tree, lines, relpath, violations)
    _check_imports(tree, lines, relpath, violations)
    return violations


def run_lint(paths=None, repo_root: str | None = None) -> PassReport:
    """Lint the given files / trees (default: the port and chip_smoke.py)."""
    if paths is None:
        root = repo_root or os.getcwd()
        paths = [os.path.join(root, p) for p in DEFAULT_ROOTS
                 if os.path.exists(os.path.join(root, p))]
    rep = PassReport("lint")
    for path in iter_py_files(paths):
        rep.case(os.path.relpath(path, repo_root) if repo_root else path)
        rep.violations.extend(lint_file(path, repo_root))
    return rep
