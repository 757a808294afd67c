"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``.

* A subprocess with ``jax`` blocked in ``sys.modules`` imports every module
  of ``repro_torch``.
* An AST scan of every file of the port, and of ``chip_smoke.py``, finds no
  import of ``jax`` or ``repro`` (``repro_torch`` is the port itself).
"""
import ast
import importlib
import json
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
            "repro_torch.launch.distributed_ridge",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.llama3_2_3b", "repro_torch.models",
            "repro_torch.models.api", "repro_torch.models.layers",
            "repro_torch.models.module", "repro_torch.data.tokens",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.launch.lm_probe", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.train", "repro_torch.train.trainer",
            "repro_torch.train.elastic", "repro_torch.launch.train",
            "repro_torch.launch.train_lm", "repro_torch.launch.inputs",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.flash_decode",
            "repro_torch.launch.lasso"} <= set(mods)
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
            "kernels/gram/gram_kernel.py", "configs/base.py",
            "models/api.py", "models/layers.py", "models/module.py",
            "models/mamba2.py", "models/moe.py",
            "data/tokens.py", "serve/engine.py", "launch/serve.py",
            "launch/lm_probe.py", "optim/adamw.py", "optim/schedules.py",
            "train/trainer.py", "train/elastic.py", "launch/train.py",
            "launch/train_lm.py", "launch/inputs.py", "launch/dryrun.py",
            "launch/roofline.py", "launch/flash_decode.py",
            "launch/lasso.py", "launch/solver_dryrun.py"} <= names


# Names of the reference's packages that have no twin in the port, each with
# its ground (ROADMAP.md, queue 1's "No twin owed" and queue 3).
NO_TWIN = {
    "repro.core": {
        # XLA lowering and the TPU mesh: SolverWorld and the dry run's
        # --verify replace them
        "lower_solver", "lower_solver_batched", "make_solver_mesh",
        # HLO text analysis: Comm.counters() and WireTap replace it
        "count_in_compiled", "parse_collectives",
        # a typing Protocol; the port's formulations are duck-typed
        "Formulation"},
    "repro.models": {
        # the compile-only dry run's abstract arrays: the port's meta
        # tensors (launch/inputs.py) take their place
        "abstract_params",
        # with_sharding_constraint on an activation: the port's
        # activations are placed by the layers that compute them
        "constrain"},
    "repro.configs": set(), "repro.data": set(),
    "repro.serve": set(), "repro.optim": set(),
    "repro.train": set(),
}


@pytest.fixture(scope="module")
def reference_exports():
    """``__all__`` of each reference package of NO_TWIN, read in one
    subprocess (the reference needs jax; the port's processes stay free of
    it)."""
    code = ("import importlib, inspect, json\n"
            "out = {m: sorted(importlib.import_module(m).__all__)"
            f" for m in {sorted(NO_TWIN)!r}}}\n"
            "from repro.train.elastic import plan_mesh\n"
            "out['plan_mesh'] = [(p.name, repr(p.default), str(p.kind))"
            " for p in inspect.signature(plan_mesh).parameters.values()]\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_plan_mesh_signature_matches_the_reference(reference_exports):
    """The grid planner takes the reference's arguments, defaults and
    kinds (its arithmetic: ``test_torch_sharding.py``)."""
    import inspect

    from repro_torch.train.elastic import plan_mesh
    got = [[p.name, repr(p.default), str(p.kind)]
           for p in inspect.signature(plan_mesh).parameters.values()]
    assert got == reference_exports["plan_mesh"]


@pytest.mark.parametrize("ref", sorted(NO_TWIN))
def test_package_exports_match_the_reference(ref, reference_exports):
    """Each ported package exports what the reference's does, less the names
    with no twin."""
    port = importlib.import_module(ref.replace("repro", "repro_torch", 1))
    missing = set(reference_exports[ref]) - NO_TWIN[ref] - set(port.__all__)
    assert not missing, sorted(missing)
    assert all(hasattr(port, name) for name in port.__all__)
