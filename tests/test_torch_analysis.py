"""The port's contract engine (``repro_torch.analysis``), the tuning
table's loaders and the solver dry run, on the CPU.

One module-scoped gloo :class:`SolverWorld` of four CPU ranks serves the
sweep, the mutation checks and the dry run's ``--verify``.  The contract
pass runs every registered solver on it and reads each rank's record of
its collective calls; the mutants (``_torch_analysis_mutants.py``, the
counterparts of the reference's ``_analysis_checks.py``) must each fail it
with a violation naming the case.  Each formulation's contracts equal its
reference twin's field by field, the kinds mapped to the port's names.
The checks that read the CUDA allocator (panel-free, operand-copy-free) run
on the card, in ``chip_smoke.py`` phase 10; here they are skipped with
their reason.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import _torch_analysis_mutants as M
import repro.core  # noqa: F401  (registers the reference formulations)
import repro_torch.core as T
from repro.core.engine import FORMULATIONS as REF_FORMULATIONS
from repro_torch.analysis import (check_chunk, check_plan, expect_clean,
                                  expect_collectives, lint_file,
                                  run_contract_pass, run_lint, run_plan_pass)
from repro_torch.core import collectives, engine
from repro_torch.kernels.gram import PacketPlan, tuning
from repro_torch.launch import solver_dryrun

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH",
                                                           "")])}
BUILTINS = ("accelerated", "dual", "primal", "proximal")


@pytest.fixture(scope="module")
def world():
    with T.SolverWorld(4, device="cpu", timeout=120) as w:
        yield w


@pytest.fixture
def live_table():
    """Restore the live tuning table after the test."""
    saved = dict(tuning._TABLE)
    yield
    tuning._TABLE.clear()
    tuning._TABLE.update(saved)


# --------------------------------------------------------------------------
# the contracts
# --------------------------------------------------------------------------

KIND = {"all-reduce": "all_reduce", "collective-permute": "hop"}


@pytest.mark.parametrize("name", BUILTINS)
def test_contracts_equal_the_reference_twins(name):
    """Field by field, with the reference's HLO kinds mapped to Comm's
    calls, its Pallas impls to the CUDA one and lowering_kwargs to
    sweep_kwargs."""
    ref = REF_FORMULATIONS[name].contracts()
    got = dataclasses.asdict(engine.FORMULATIONS[name].contracts())
    want = dataclasses.asdict(ref)
    want["collective_kinds"] = tuple(KIND[k] for k in ref.collective_kinds)
    want["pipelined_collective_kinds"] = tuple(
        KIND[k] for k in ref.pipelined_collective_kinds)
    want["panel_free_impls"] = ("cuda",)
    want["sweep_kwargs"] = want.pop("lowering_kwargs")
    assert got == want
    assert got["sync_per_outer"] == 1      # the paper's headline contract


def test_ring_hops_follow_the_declared_law():
    law = engine.SolverContracts().pipelined_hops
    assert law == (2, -2)
    for P in (1, 2, 3, 4):
        assert engine.ring_hops([P]) == engine.ring_hops([P], law) == 2 * (P - 1)
    assert engine.ring_hops([4, 2], (1, 0)) == 6


def test_comm_needs_its_device():
    with pytest.raises(TypeError):
        engine.Comm(None)


# --------------------------------------------------------------------------
# the contract pass on four CPU ranks
# --------------------------------------------------------------------------

def test_sweep_passes_on_every_registered_solver(world):
    rep = run_contract_pass(world)
    assert rep.ok, "\n".join(map(str, rep.violations))
    # 3 ridge-family formulations x (4 local + 1 bind_shard + 4 sharded +
    # 4 guarded + 4 batched + 1 f64 + 2 pipelined + 2 guarded + 2 batched)
    # = 72, plus the accelerated (not tenant-batched) at 18.
    assert len(rep.cases) == 90, rep.cases
    reasons = {r for _, r in rep.skipped}
    assert len(rep.skipped) == 8 and len(reasons) == 2, rep.skipped
    assert any("CUDA tensors only" in r for r in reasons)
    assert any("on the card only" in r for r in reasons)


def test_sweep_reads_every_rank_and_the_payload_law(world):
    """The records the pass reads: a sharded s = 2 solve of 4 iterations
    is 2 all-reduces of sb (sb + 1) + 5 words in f32 on every rank, and the
    tap saw the calls and words Comm counted (the bytes and dtypes are
    Comm's alone)."""
    world.tap_wire = True
    try:
        d, n = 64, 128
        X, y = torch.randn(d, n, dtype=torch.float64), torch.randn(n)
        T.ca_bcd_sharded(world, X.float(), y, 1e-3, 4, 2, 4,
                         idx=T.sample_blocks(torch.Generator().manual_seed(0),
                                             d, 4, 4))
    finally:
        world.tap_wire = False
    for comm, wire in zip(world.last["counters"], world.last["wire"]):
        s = expect_collectives(comm, 2, subject="sharded s=2")
        assert s.words == 2 * (8 * 9 + engine.HEALTH_WORDS)
        assert s.bytes == 4 * s.words and s.dtypes == {"float32"}
        tapped = collectives.collective_summary(wire)
        assert tapped.by_kind == s.by_kind and tapped.count == s.count
        assert tapped.bytes == 0 and not tapped.dtypes


@pytest.mark.parametrize("mutant, check, where, word", [
    ("second_all_reduce", "collective-count", "/sharded[", "all_reduce"),
    ("guard_reduce", "collective-count", ",guard]", "all_reduce"),
    ("extra_hop", "collective-count", "/pipelined[", "hop"),
    ("pretranspose", "operand-transpose", "/bind_shard[", "transposed copy"),
    ("no_contracts", "contracts-missing", "evil-no-contracts", "contracts"),
])
def test_mutation_caught(world, mutant, check, where, word):
    """Each mutant fails the sweep with a violation naming its case and
    the offending call; the extra collectives also show as calls outside
    Comm."""
    with M.registered(mutant) as name:
        rep = run_contract_pass(world, formulations=[name])
    assert name not in engine.FORMULATIONS
    assert not rep.ok
    hits = [v for v in rep.violations if v.check == check]
    assert hits, rep.violations
    assert any(name in v.subject and where in v.subject
               and word in v.message for v in hits), hits
    if check == "collective-count":
        assert any(v.check == "collective-outside-comm"
                   for v in rep.violations)


@pytest.mark.parametrize("mutant, check", [
    ("oversized_entry", "bucket-consistency"),
    ("residual_order", "residual-order")])
def test_table_mutation_caught(mutant, check):
    assert run_plan_pass().ok
    with M.table(mutant):
        rep = run_plan_pass()
    assert run_plan_pass().ok            # the live table is restored
    hits = [v for v in rep.violations if v.check == check]
    assert hits, rep.violations
    # named at the entry (and, for the residual order, at the real-sim
    # shard shape the entry's bucket holds: m = 128, K = 18078)
    assert any("table[128,32768,float32,rows]" in v.subject for v in hits)
    assert {v.check for v in rep.violations} == {check}


def test_cli_sweep_exits_nonzero_on_a_mutant(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_analysis_mutants.py"),
         "second_all_reduce", "--out", str(out)], cwd=ROOT, env=ENV,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert "ANALYSIS FAIL" in proc.stdout
    assert "evil-second-all-reduce/sharded[" in proc.stdout
    report = json.loads(out.read_text())
    assert not report["ok"] and report["meta"]["ranks"] == 4


# --------------------------------------------------------------------------
# the plan pass
# --------------------------------------------------------------------------

def test_plan_pass_clean_on_the_live_table():
    rep = run_plan_pass()
    assert rep.ok, rep.violations
    # the default picks: 2 dtypes x 2 layouts x 5 m x 4 K
    assert len(rep.cases) == 80 + len(tuning.table_entries())


def test_check_chunk_flags_each_limit():
    f32 = "float32"
    assert not check_chunk(128, 72309, f32, "rows", None, "t")
    assert not check_chunk(8, 20958, "float64", "cols", 64, "t")
    kinds = {v.check for v in check_chunk(8, 1000, f32, "rows", 48, "t")}
    assert kinds == {"chunk-alignment"}
    vs = check_chunk(8, 32 * 70000, f32, "rows", 32, "t")
    assert [v.check for v in vs] == ["split-count"]
    vs = check_chunk(8, 1000, "bfloat16", "rows", None, "t")
    assert [v.check for v in vs] == ["kernel-geometry"]
    vs = check_chunk(2 ** 22, 64, f32, "rows", None, "t")
    assert "index-arithmetic" in {v.check for v in vs}
    assert [v.check for v in check_chunk(8, 100, f32, "diag", None, "t")] \
        == ["plan-key"]


def test_check_chunk_flags_the_smem_budget(monkeypatch):
    from repro_torch.kernels.gram import sampled_kernel
    monkeypatch.setattr(sampled_kernel, "SMEM_PER_BLOCK", 1024)
    vs = check_chunk(128, 72309, "float32", "rows", None, "t")
    assert vs and {v.check for v in vs} == {"smem-budget"}, vs
    assert all("shared memory" in v.message for v in vs)


def test_check_plan_validates_impl_and_chunk():
    assert not check_plan(PacketPlan(impl="cuda", bk=64), 8, 1000)
    vs = check_plan(PacketPlan(impl="ref", bk=4096 * 32), 128, 72309,
                    layout="cols")
    assert not vs                      # one split: a legal (slow) chunk
    # PacketPlan refuses an unknown impl itself; a plan-like object from
    # elsewhere (a loaded config) is checked here
    vs = check_plan(SimpleNamespace(impl="tpu", bk=None), 8, 100)
    assert [v.check for v in vs] == ["plan-impl"]


# --------------------------------------------------------------------------
# the tuning table's loaders
# --------------------------------------------------------------------------

def test_tuning_loaders_round_trip(tmp_path, live_table):
    entry = {"128,65536,float32,rows": 1024, "8,32768,float64,cols": 256}
    tuning.register_table(entry)
    snap = tuning.table_snapshot()
    assert {k: snap[k] for k in entry} == entry
    assert tuning.pick_tiles(100, 40000, torch.float32, "rows") == 1024
    assert tuning.pick_tiles(8, 20958, torch.float64, "cols") == 256
    assert ((128, 65536, "float32", "rows"), 1024) in tuning.table_entries()
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"table": snap}))
    tuning._TABLE.clear()
    assert tuning.load_table(str(path)) == len(snap)
    assert tuning.table_snapshot() == snap
    with pytest.raises(ValueError):
        tuning.register_table({"8,64,float32,diag": 64})


def test_tuning_env_table_loads_and_a_bad_path_raises(tmp_path):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"8,1024,float32,rows": 512}))
    code = ("import torch\nfrom repro_torch.kernels.gram import tuning\n"
            "print(tuning.pick_tiles(8, 1000, torch.float32))\n")
    ok = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120, cwd=ROOT,
                        env={**ENV, tuning.ENV_TABLE: str(path)})
    assert ok.returncode == 0 and ok.stdout.split() == ["512"], ok.stderr
    # a bad path goes on raising at every pick, also once a caller has
    # caught the first error
    code = ("import torch\nfrom repro_torch.kernels.gram import tuning\n"
            "try:\n    tuning.pick_tiles(8, 1000, torch.float32)\n"
            "except FileNotFoundError:\n    print('caught')\n"
            "print(tuning.pick_tiles(8, 1000, torch.float32))\n")
    bad = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**ENV, tuning.ENV_TABLE: str(tmp_path / "no")})
    assert bad.returncode != 0 and bad.stdout.split() == ["caught"]
    assert "FileNotFoundError" in bad.stderr and tuning.ENV_TABLE in bad.stderr


# --------------------------------------------------------------------------
# the lint pass
# --------------------------------------------------------------------------

def test_lint_clean_on_the_port():
    rep = run_lint(repo_root=str(ROOT))
    assert rep.ok, "\n".join(map(str, rep.violations))
    assert len(rep.cases) > 40 and "chip_smoke.py" in rep.cases


def test_lint_catches_raw_collectives_and_honours_a_waiver(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch\n"
        "import torch.distributed as dist\n"
        "from torch.distributed import all_reduce as ar\n"
        "def f(x):\n"
        "    dist.all_reduce(x)\n"
        "    torch.distributed.broadcast(x, 0)\n"
        "    ar(x)\n"
        "    return dist.get_rank()\n")
    vs = lint_file(str(bad))
    assert [(v.check, v.subject.split(":")[-1]) for v in vs] == [
        ("raw-collective", "5"), ("raw-collective", "6"),
        ("raw-collective", "7")], vs
    ok = tmp_path / "ok.py"
    ok.write_text(
        "import torch.distributed as dist\n"
        "def f(x):\n"
        "    # contract: allow-collective (a reviewed exception)\n"
        "    dist.all_reduce(x)\n")
    assert not lint_file(str(ok))


def test_lint_catches_operand_transposes_and_foreign_imports(tmp_path):
    bad = tmp_path / "form.py"
    bad.write_text(
        "import jax\n"
        "from repro.core import engine\n"
        "import repro_torch.core\n"
        "class Form:\n"
        "    def bind_shard(self, Xl):\n"
        "        a = Xl.T\n"
        "        b = Xl.t()\n"
        "        c = Xl.transpose(0, 1)\n"
        "        return Xl.mT  # contract: allow-transpose\n"
        "class Helper:\n"
        "    def other(self, Xl):\n"
        "        return Xl.T\n")
    checks = sorted((v.check, int(v.subject.split(":")[-1]))
                    for v in lint_file(str(bad)))
    assert checks == [("foreign-import", 1), ("foreign-import", 2),
                      ("operand-transpose", 6), ("operand-transpose", 7),
                      ("operand-transpose", 8)], checks
    # the pre-transpose mutant is caught statically too
    vs = lint_file(str(ROOT / "tests" / "_torch_analysis_mutants.py"))
    assert [v.check for v in vs] == ["operand-transpose"], vs


# --------------------------------------------------------------------------
# summaries, assertions, the solver dry run
# --------------------------------------------------------------------------

def test_summaries_add_records_up():
    rec = {"all_reduces": 2, "words": 10, "hops": 3, "hop_words": 6,
           "bytes": 64, "dtypes": ("float32",)}
    one = collectives.collective_summary(rec)
    assert (one.count, one.words, one.calls("hop")) == (5, 16, 3)
    two = collectives.summarize([rec, {**rec, "dtypes": ("float64",)}])
    assert two.count == 10 and two.bytes == 128
    assert two.dtypes == {"float32", "float64"}
    assert "all_reduce: n=4" in str(two)
    expect_clean({**rec, "all_reduces": 0, "words": 0, "hops": 0,
                  "hop_words": 0})
    with pytest.raises(AssertionError, match="disallowed"):
        expect_collectives(rec, 2)
    with pytest.raises(AssertionError, match="expected exactly 3"):
        expect_collectives(rec, 3, kinds=("all_reduce", "hop"))


def test_solver_dryrun_schedule_without_a_world(tmp_path):
    rows = solver_dryrun.run(str(tmp_path), "primal")
    assert (tmp_path / "solver_cells.json").exists()
    by = {(r["chips"], r["s"], r["fused"], r["wire"]): r for r in rows}
    assert len(by) == 10
    assert by[256, 1, False, "psum"]["all_reduces"] == 8
    assert by[256, 8, True, "psum"]["all_reduces"] == 1
    assert by[256, 8, True, "psum"]["words"] == 64 * 65 + 5
    assert by[512, 8, True, "ring"]["hops"] == 2 * 511
    assert by[512, 8, True, "ring"]["all_reduces"] == 0
    for r in rows:
        assert 0.0 <= r["modeled_overlap_ratio"] <= 1.0
        assert r["machine"] == "h100-nvlink-nccl"


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_solver_dryrun_verifies_on_four_ranks(world, form):
    rows = solver_dryrun.verify(4, form, world=world)
    assert [(r["s"], r["wire"]) for r in rows] == [
        (1, "psum"), (4, "psum"), (4, "psum"), (8, "psum"), (8, "ring")]
    assert rows[-1]["hops"] == 6 and rows[0]["all_reduces"] == 8


@pytest.mark.parametrize("tenants", [1, 8, 64])
def test_solver_dryrun_batched_all_reduces_do_not_scale_with_tenants(
        tmp_path, tenants):
    """The batched cells: H all-reduces whatever T; sb^2 + T sb words an
    outer step (the shared Gram not scaled by T)."""
    rows = solver_dryrun.run_batched(tenants, str(tmp_path), "primal")
    assert (tmp_path / f"solver_cells_batched_T{tenants}.json").exists()
    by = {(r["chips"], r["s"]): r for r in rows}
    assert sorted(by) == [(P, s) for P in (256, 512) for s in (1, 4, 8)]
    for (P, s), r in by.items():
        assert r["all_reduces"] == 8 // s and r["hops"] == 0
        sb = s * 8
        assert r["words"] == (8 // s) * (sb * sb + tenants * sb)
        assert r["modeled_solves_per_s"] > 0
        assert r["modeled_bytes_per_iter_per_tenant"] > 0
    one = solver_dryrun.run_batched(1, str(tmp_path), "primal")
    for r, r1 in zip(rows, one):
        assert r["all_reduces"] == r1["all_reduces"]
        assert r["words"] - r1["words"] == (tenants - 1) * 8 * 8


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_solver_dryrun_verifies_batched_on_four_ranks(world, form):
    rows = solver_dryrun.verify(4, form, world=world, tenants=8)
    assert [r["s"] for r in rows] == [1, 4, 8]
    for r in rows:
        assert r["all_reduces_by_rank"] == [8 // r["s"]] * 4
