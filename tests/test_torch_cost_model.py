"""The port's cost model (``repro_torch.core.cost_model``) against the
reference's (``repro.core.cost_model``).

Both are float64 numpy (and python floats) on the same formulas, so every
ported function agrees with its reference twin to a relative 1e-12, on the
paper's Cori models and on a ``MachineModel`` built from the reference's
TPU constants (the port keeps no TPU rate of its own).  The H100 additions
(``kernel_smem_bytes``, the sector-granule default of ``packet_hbm_bytes``,
``fit_wire``, the measured-time overrides of ``snapshot_cadence``) are
checked against the kernels' geometries and against Young's rule.
"""
import math

import numpy as np
import pytest
import torch

import repro.core.cost_model as R
import repro_torch.core.cost_model as T
from repro_torch.kernels.gram.gram_kernel import dense_geometry
from repro_torch.kernels.gram.sampled_kernel import (SMEM_PER_BLOCK,
                                                     matvec_geometry)

RTOL = 1e-12


def _machines():
    """(port model, reference model) pairs: the Cori models and the
    reference's TPU constants rebuilt in the port's type."""
    out = [(T.CORI_MPI, R.CORI_MPI), (T.CORI_SPARK, R.CORI_SPARK)]
    for ref in (R.TPU_V5E_ICI, R.TPU_V5E_DCN):
        out.append((T.MachineModel(ref.name, ref.gamma, ref.alpha, ref.beta),
                    ref))
    return out


MACHINES = _machines()
MACHINE_IDS = [m.name for m, _ in MACHINES]
# (d, n, P, b, H, s): the paper's Cori point, a small one, real-sim on the
# four ranks of one card, and the solver dry run's production point.
GRID = [(1024, 2 ** 22, 1024, 4, 1000, 8), (64, 256, 4, 4, 12, 3),
        (20958, 72309, 4, 8, 256, 16), (4096, 1 << 22, 512, 8, 8, 4)]
TENANTS = (1, 8, 64)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=0)


def _costs(c):
    return [c.flops, c.latency, c.bandwidth, c.memory]


@pytest.mark.parametrize("g", GRID)
@pytest.mark.parametrize("fn", ["bcd_costs", "bdcd_costs"])
def test_theorem_costs_match_reference(g, fn):
    d, n, P, b, H, s = g
    _close(_costs(getattr(T, fn)(d, n, P, b, H, s)),
           _costs(getattr(R, fn)(d, n, P, b, H, s)))


@pytest.mark.parametrize("g", GRID)
def test_table2_costs_match_reference(g):
    d, n, P, *_ = g
    for k in (1, 50):
        _close(_costs(T.cg_costs(d, n, P, k)), _costs(R.cg_costs(d, n, P, k)))
    _close(_costs(T.tsqr_costs(d, n, P)), _costs(R.tsqr_costs(d, n, P)))


@pytest.mark.parametrize("machine", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("g", GRID)
def test_time_matches_reference(machine, g):
    m, mr = machine
    d, n, P, b, H, s = g
    _close(T.bcd_costs(d, n, P, b, H, s).time(m),
           R.bcd_costs(d, n, P, b, H, s).time(mr))
    _close(T.bdcd_costs(d, n, P, b, H, s).time(m),
           R.bdcd_costs(d, n, P, b, H, s).time(mr))


@pytest.mark.parametrize("formulation", ["primal", "dual"])
@pytest.mark.parametrize("g", GRID)
def test_batched_costs_match_reference(g, formulation):
    d, n, P, b, H, s = g
    for tenants in TENANTS:
        _close(_costs(T.batched_costs(d, n, P, b, H, s, tenants, formulation)),
               _costs(R.batched_costs(d, n, P, b, H, s, tenants,
                                      formulation)))
        _close(T.tenant_bytes_per_iter(d, n, P, b, s, tenants, formulation),
               R.tenant_bytes_per_iter(d, n, P, b, s, tenants, formulation))
        for m, mr in MACHINES:
            kw = dict(d=d, n=n, P=P, b=b, H=H, s=s, tenants=tenants,
                      formulation=formulation)
            _close(T.batched_solves_per_second(m, **kw),
                   R.batched_solves_per_second(mr, **kw))


@pytest.mark.parametrize("machine", MACHINES, ids=MACHINE_IDS)
def test_wire_schedules_match_reference(machine):
    m, mr = machine
    for payload in (77.0, 16517.0, 4165.0):
        for axes in ((4,), (16, 16), (2, 16, 16), (1, 8)):
            _close(T.ring_wire_costs(payload, axes),
                   R.ring_wire_costs(payload, axes))
            _close(T.ring_wire_time(m, payload, axes),
                   R.ring_wire_time(mr, payload, axes))
        for P in (1, 2, 4, 512):
            _close(T.psum_wire_time(m, payload, P),
                   R.psum_wire_time(mr, payload, P))


@pytest.mark.parametrize("machine", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("formulation", ["primal", "dual"])
def test_pipeline_schedule_matches_reference(machine, guard, formulation):
    m, mr = machine
    for axes, b, s, tenants in (((4,), 8, 16, 1), ((16, 16), 8, 8, 64),
                                ((2, 16, 16), 4, 2, 8)):
        kw = dict(d=4096, n=1 << 22, axis_sizes=axes, b=b, s=s,
                  tenants=tenants, formulation=formulation, guard=guard)
        got, want = T.pipeline_schedule(m, **kw), R.pipeline_schedule(mr, **kw)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
        _close(T.overlap_ratio(m, **kw), R.overlap_ratio(mr, **kw))


@pytest.mark.parametrize("machine", MACHINES, ids=MACHINE_IDS)
@pytest.mark.parametrize("formulation", ["primal", "dual"])
def test_snapshot_cadence_matches_reference(machine, formulation):
    m, mr = machine
    for mtbf in (10.0, 1e4):
        kw = dict(d=20958, n=72309, P=4, b=8, s=16, mtbf_outer=mtbf,
                  formulation=formulation)
        got, want = T.snapshot_cadence(m, **kw), R.snapshot_cadence(mr, **kw)
        assert got["cadence"] == want["cadence"]
        for k in ("t_snap", "t_step", "overhead"):
            _close(got[k], want[k])


@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("panel_free", [True, False])
def test_packet_bytes_at_the_tpu_lane_match_reference(layout, panel_free):
    for sb, n, isz, bm in ((8, 72309, 4, 128), (128, 20958, 4, 32),
                           (256, 5240, 8, 64)):
        _close(T.packet_hbm_bytes(sb, n, isz, panel_free, bm, layout,
                                  lane=128),
               R.packet_hbm_bytes(sb, n, isz, panel_free, bm, layout,
                                  lane=128))
        _close(T.packet_memory_time(sb, n, 3.35e12, isz, panel_free, bm),
               R.packet_memory_time(sb, n, 3.35e12, isz, panel_free, bm))
    got = T.packet_traffic_breakdown(128, 72309, 4, 32)
    want = R.packet_traffic_breakdown(128, 72309, 4, 32)
    for k in want:
        _close(got[k], want[k])


def test_dual_tradeoff_matches_reference_at_pinned_tiles():
    for d, n, sb in ((20958, 72309, 128), (4096, 1 << 22, 8)):
        got = T.dual_operand_tradeoff(d, n, sb, 4, bm_rows=32, bm_cols=16,
                                      lane=128)
        want = R.dual_operand_tradeoff(d, n, sb, 4, bm_rows=32, bm_cols=16,
                                       lane=128)
        for side in want:
            for k in want[side]:
                _close(got[side][k], want[side][k])


def test_packet_bytes_default_to_the_sector_granule():
    """The column layout's default amplification is one 32-byte sector a
    scattered element: 8 f32 or 4 f64 elements, not the TPU's 128 lanes."""
    for isz, lane in ((4, 8), (8, 4)):
        assert (T.packet_hbm_bytes(128, 20958, isz, layout="cols")
                == T.packet_hbm_bytes(128, 20958, isz, layout="cols",
                                      lane=lane))
    assert (T.packet_hbm_bytes(128, 72309, layout="rows")
            == T.packet_hbm_bytes(128, 72309, layout="rows", lane=128))
    with pytest.raises(ValueError):
        T.packet_hbm_bytes(8, 100, layout="diag")


def test_dual_tradeoff_defaults_to_the_kernels_tile_edges():
    got = T.dual_operand_tradeoff(20958, 72309, 128)
    rows = dense_geometry(128, 20958, torch.float32, source="rows").bm
    cols = dense_geometry(128, 20958, torch.float32, source="cols").bm
    assert got == T.dual_operand_tradeoff(20958, 72309, 128, bm_rows=rows,
                                          bm_cols=cols)


@pytest.mark.parametrize("machine", MACHINES, ids=MACHINE_IDS)
def test_best_s_and_scaling_match_reference(machine):
    m, mr = machine
    for fn in ("bcd_costs", "bdcd_costs"):
        got = T.best_s(getattr(T, fn), m, 1024, 2 ** 22, 1024, 4, 1000)
        want = R.best_s(getattr(R, fn), mr, 1024, 2 ** 22, 1024, 4, 1000)
        assert got[0] == want[0]
        _close(got[1], want[1])
    Ps = [2 ** k for k in range(2, 29, 4)]
    for got, want in (
            (T.strong_scaling(m, d=1024, n=2 ** 35, b=4, H=1000, Ps=Ps),
             R.strong_scaling(mr, d=1024, n=2 ** 35, b=4, H=1000, Ps=Ps)),
            (T.weak_scaling(m, d=1024, n_per_P=2 ** 11, b=4, H=1000, Ps=Ps),
             R.weak_scaling(mr, d=1024, n_per_P=2 ** 11, b=4, H=1000,
                            Ps=Ps))):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])


@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_smem_is_the_kernels_own_geometry(layout, dtype):
    """The modelled footprint is the launched one: the larger of the
    packet's ring and the matvec's, from the kernels' host geometries,
    within the block's budget at every shape of the solves."""
    for m, K in ((8, 72309), (128, 72309), (128, 20958), (77, 5240)):
        got = T.kernel_smem_bytes(m, K, dtype, layout)
        want = max(dense_geometry(m, K, dtype, source=layout).smem,
                   matvec_geometry(m, K, 1, dtype, layout).smem)
        assert got == want <= SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        T.kernel_smem_bytes(8, 100, layout="diag")


def test_snapshot_cadence_follows_youngs_rule():
    """k* = round(sqrt(2 mtbf t_snap / t_step)), at least 1, with measured
    times in place of the modelled ones; the overhead is the snapshot's
    share plus the expected replay's."""
    for t_snap, t_step, mtbf in ((2.9e-3, 8.8e-3, 1e4), (1e-3, 1.0, 10.0),
                                 (0.5, 1e-3, 100.0)):
        got = T.snapshot_cadence(T.H100_LOCAL, d=20958, n=72309, P=1, b=8,
                                 s=16, mtbf_outer=mtbf, t_snap=t_snap,
                                 t_step=t_step)
        k = max(1, round(math.sqrt(2 * mtbf * t_snap / t_step)))
        assert got["cadence"] == k
        assert got["t_snap"] == t_snap and got["t_step"] == t_step
        _close(got["overhead"], t_snap / (k * t_step) + k / (2 * mtbf))
    with pytest.raises(ValueError):
        T.snapshot_cadence(T.H100_LOCAL, d=1, n=1, P=1, b=1, s=1,
                           mtbf_outer=0)


def test_fit_wire_recovers_the_alpha_beta_law():
    P, alpha, beta = 4, 1.2e-3, 6e-9
    pts = [(w, T.psum_wire_time(T.MachineModel("x", 0, alpha, beta), w, P))
           for w in (77, 16517, 4165)]
    got = T.fit_wire(pts, P)
    _close(got, (alpha, beta))
    # a wire that does not grow with the payload fits beta = 0
    a, b = T.fit_wire([(77, 5e-3), (16517, 4e-3)], P)
    assert b == 0.0 and a == pytest.approx(4.5e-3 / 4)


def test_h100_models_are_the_documented_constants():
    """gamma from 67 TFLOP/s f32 everywhere; no wire on one card; the gloo
    model from the phase-9 times in PERF.md section 5's table;
    NVLink's 450 GB/s each way."""
    for m in (T.H100_LOCAL, T.H100_GLOO, T.H100_NVLINK):
        assert m.gamma == 1 / 67e12
        assert m.name in T.MACHINES
    assert T.H100_LOCAL.alpha == T.H100_LOCAL.beta == 0.0
    ts = [5.650e-3, 4.223e-3, 5.318e-3, 4.967e-3]
    # beta is not resolved by the four times: committed 0, and alpha is
    # their mean over the tree's 2 log2(4) messages, the model's wire time
    # on four ranks at any payload is that mean
    assert T.H100_GLOO.beta == 0.0
    assert T.H100_GLOO.alpha == pytest.approx(sum(ts) / 4 / 4, rel=1e-12)
    for words in (77, 16517):
        assert T.psum_wire_time(T.H100_GLOO, words, 4) == pytest.approx(
            sum(ts) / 4, rel=1e-12)
    assert T.H100_NVLINK.beta == 4 / 450e9
    assert not any(name.startswith("tpu") for name in T.MACHINES)
