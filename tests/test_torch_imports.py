"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``.

* A subprocess with ``jax`` blocked in ``sys.modules`` imports every module
  of ``repro_torch``.
* An AST scan of every file of the port, and of ``chip_smoke.py``, finds no
  import of ``jax`` or ``repro`` (``repro_torch`` is the port itself).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert {"repro_torch.launch.quickstart", "repro_torch.core.proximal",
            "repro_torch.serve.solver_service", "repro_torch.core.krylov",
            "repro_torch.core.tsqr",
            "repro_torch.kernels.gram.gram_kernel",
            "repro_torch.core.accelerated", "repro_torch.faults.supervisor",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.core.distributed", "repro_torch.core.world",
            "repro_torch.launch.distributed_ridge"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax_or_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    assert {"core/engine.py", "core/proximal.py",
            "kernels/gram/sampled_kernel.py",
            "kernels/gram/sampled_colmajor.py", "interop.py",
            "launch/quickstart.py", "serve/slots.py",
            "serve/solver_service.py", "core/krylov.py", "core/tsqr.py",
            "kernels/gram/gram_kernel.py"} <= names
