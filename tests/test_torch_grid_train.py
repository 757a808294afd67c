"""Training on a grid of ranks (``train.trainer`` with a
``core.world.GridComm``; ``models.api.GridLayout``; ``optim.adamw``'s
ZeRO-1; ``launch/grid_train.py``) against the reference's train step and
the port's own one-process step, on the CPU.

One module world of four gloo CPU ranks serves every grid.  The model is
llama3.2-3b reduced (4 q heads, 2 kv heads, d_ff 128, vocab 256) in f64
(``tests/_x64.py``), its weights the reference's through ``interop``.

Tolerances:
* a grid's step against the port's one-process step on the same weights
  and batch: loss, grad norm and every assembled leaf of params, master, m
  and v within 1e-10 (relative; each leaf against its norm).  The sums are
  regrouped (the rows over 'data', heads and vocab columns over 'model');
  the f32 optimizer state rounds the f64 gradients the same way on both
  sides but where a difference of 1e-16 crosses an f32 rounding boundary;
* the same steps against the reference's jitted ``make_train_step`` (no
  mesh) on its own weights: the reference's x64 run still casts its
  logits and einsum results to f32 (its ``loss_fn``'s ``astype(f32)``,
  ``preferred_element_type``), so it is held at ``test_torch_optim``'s f32
  tolerances (loss atol 1e-5, grad norm and m / v rtol 5e-4, each leaf's
  move 2e-3 of its norm);
* two microbatches on (2, 2) against the one-process step with two: the
  microbatches' gradients accumulate in f32 (the reference's
  accumulators), so the clip's global norm is an f32 sum that the grid
  regroups over its blocks; loss, grad norm and every leaf within 1e-6
  (a few f32 ulps, 2^-23 = 1.2e-7; read on the CPU: 1.1e-7 on the grad
  norm and 3.1e-7 on v with ZeRO-1, 0 with FSDP);
* ZeRO-1 on a (2, 1) grid against the replicated data-parallel world of
  two ranks (``run_data_parallel``), f32: ``torch.equal`` on every leaf;
* a checkpoint written on 2 x 2 restored on 1 x 2 and 4 x 1: the same bits.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import init_params as jinit
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as j_init_opt_state
from repro.train import make_train_step as j_make_train_step
import repro_torch.configs as tconfigs
from repro_torch.core import SolverWorld
from repro_torch.data import TokenStream
from repro_torch.interop import (lm_params_from_reference,
                                 train_state_from_reference,
                                 train_state_to_numpy)
from repro_torch.launch.grid_train import (grid_train_steps,
                                           one_process_steps,
                                           restore_on_grid)
from repro_torch.models import api
from repro_torch.core.grid import as_grid
from repro_torch.models.module import tree_map
from repro_torch.models.sharding import make_rules
from repro_torch.optim.adamw import zero_plan
from repro_torch.train import TrainRunConfig, run_data_parallel

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

GRID_TOL = 1e-10
MICROBATCH_TOL = 1e-6
STEP_LOSS_TOL = 1e-5
MOMENT_TOL = 5e-4
MOVE_TOL = 2e-3
LR = 1e-3


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False) as w:
        yield w


def _f64(get, arch, **kw):
    f64 = torch.float64 if get is tconfigs.get_reduced else jnp.float64
    return dataclasses.replace(get(arch), dtype=f64, param_dtype=f64, **kw)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, dtype=np.float64)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _batch(vocab):
    batch = TokenStream(vocab, 32, 4, seed=3).batch_at(0)
    batch["mask"][1, 20:] = 0.0                  # a masked tail
    return batch


_CASES = {}


def _case(steps: int, **kw):
    """(port cfg, the reference's weights as the port's tree, the batch,
    the port's one-process result, the reference's result) of ``steps``
    steps of llama3.2-3b reduced in f64 (``kw`` replaces config fields on
    both sides)."""
    key = (steps, tuple(sorted(kw.items())))
    if key not in _CASES:
        jc, tc = (_f64(jconfigs.get_reduced, "llama3_2_3b", **kw),
                  _f64(tconfigs.get_reduced, "llama3_2_3b", **kw))
        jparams = jinit(japi.param_specs(jc), jax.random.key(0))
        jstate = {"params": jparams, "opt": j_init_opt_state(jparams),
                  "step": jnp.zeros((), jnp.int32)}
        params = train_state_from_reference(
            jax.tree.map(np.asarray, jstate), tc, device="cpu")["params"]
        batch = _batch(tc.vocab)
        jstep = jax.jit(j_make_train_step(jc, JAdamW(lr=LR)))
        for _ in range(steps):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        one_m, one, _ = one_process_steps(tc, params, batch, steps=steps,
                                          lr=LR)
        _CASES[key] = (tc, params, batch,
                       (one_m, dict(_flat(train_state_to_numpy(one)))),
                       ({k: float(v) for k, v in jm.items()},
                        dict(_flat(jax.tree.map(np.asarray, jstate)))))
    return _CASES[key]


def _hold_to_one_process(got, one_m, one, tol=GRID_TOL):
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - one_m[k]) <= tol * abs(one_m[k]), k
    new = dict(_flat(train_state_to_numpy(got["state"])))
    assert new.keys() == one.keys()
    for k in one:
        assert _rel(new[k], one[k]) <= tol, k
    return new


def _hold_to_reference(new, metrics, ref_m, ref, params):
    before = dict(_flat(train_state_to_numpy({"params": params})))
    np.testing.assert_allclose(metrics["loss"], ref_m["loss"], rtol=0,
                               atol=STEP_LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"], ref_m["grad_norm"],
                               rtol=MOMENT_TOL)
    for k in ref:
        if k[0] == "opt" and k[1] in ("m", "v"):
            assert _rel(new[k], ref[k]) < MOMENT_TOL, k
        elif k[0] == "params":
            assert _rel(new[k] - before[k], ref[k] - before[k]) < \
                MOVE_TOL, k


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)],
                         ids=lambda g: "x".join(map(str, g)))
def test_grid_step_matches_reference(world, grid, fsdp, steps):
    """Tensor parallelism over 'model', ZeRO-1 over 'data' (and FSDP)
    against the one-process step (1e-10) and the reference's."""
    tc, params, batch, (one_m, one), (ref_m, ref) = _case(steps)
    tc = dataclasses.replace(tc, fsdp=fsdp)
    got = grid_train_steps(world, grid, tc, params, batch, steps=steps,
                           lr=LR)
    new = _hold_to_one_process(got, one_m, one)
    _hold_to_reference(new, got["metrics"], ref_m, ref, params)
    g = as_grid(grid)
    plan = zero_plan(api.param_specs(tc), fsdp, g, {"data": 0, "model": 0})
    for c in got["counters"]:
        # the gradients in one all-reduce a step (one dtype; under FSDP
        # every leaf of this model is reduce-scattered instead) and the
        # loss; the norm's one scalar over the grid
        if g["data"] > 1:
            assert c["data"]["all_reduces"] == (1 if fsdp else 2)
            assert c["data"]["all_gathers"] >= sum(
                lp.gather is not None for lp in plan)
            assert (c["data"]["reduce_scatters"] > 0) == fsdp
        if g["model"] > 1:
            assert c["model"]["all_reduces"] > 0
        assert c["world"]["all_reduces"] == 1


def _microbatched_step(comm, device, *, cfg, params, batch, microbatches):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import gather_state, place_fresh
    state = place_fresh(params, cfg, comm)
    step = make_train_step(cfg, AdamWConfig(lr=LR), microbatches, comm)
    state, m = step(state, batch)
    return ({k: float(v) for k, v in m.items()},
            gather_state(state, cfg, comm))


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
def test_grid_step_with_microbatches(world, fsdp):
    """Two microbatches on (2, 2) (each reduced over 'data' in turn; under
    FSDP each reduce-scattered) against the one-process step with two
    microbatches on the same weights and batch, at MICROBATCH_TOL: the
    microbatches' gradients accumulate in f32 on both sides, so the clip's
    norm is an f32 sum, regrouped over the ranks' blocks."""
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    tc, params, batch, _, _ = _case(1)
    tc = dataclasses.replace(tc, fsdp=fsdp)
    p = tree_map(torch.clone, params, torch.is_tensor)
    one = {"params": p, "opt": init_opt_state(p),
           "step": torch.zeros((), dtype=torch.int32)}
    one, one_m = make_train_step(tc, AdamWConfig(lr=LR), 2)(one, batch)
    (got_m, got), *_ = world.run_grid(_microbatched_step, (2, 2), cfg=tc,
                                      params=params, batch=batch,
                                      microbatches=2)
    _hold_to_one_process({"metrics": got_m, "state": got},
                         {k: float(v) for k, v in one_m.items()},
                         dict(_flat(train_state_to_numpy(one))),
                         MICROBATCH_TOL)


def test_zero1_shards_the_optimizer_state(world):
    """ZeRO-1 over 'data': a rank's (master, m, v) is its 1 / D of the
    whole but the leaves whose 'embed' dimension does not split."""
    tc, params, batch, _, _ = _case(1)
    whole = sum(a.size * 12 for a in
                (np.asarray(t) for _, t in _flat(
                    train_state_to_numpy({"p": params}))))
    got = grid_train_steps(world, (4, 1), tc, params, batch, keep=False)
    assert all(b == whole // 4 for b in got["opt_bytes"])


@pytest.mark.parametrize("case", ["kv_replicated", "heads_dropped"])
def test_guarded_heads(world, case):
    """q heads cut over 'model' with the kv heads replicated (4 q and 2 kv
    heads on model = 4: each rank's q head h meets kv head h // G), and
    heads the guard drops (3 q heads on model = 2: attention whole on
    every rank), each against the one-process step at 1e-10."""
    if case == "kv_replicated":
        grid, kw = (1, 4), {}
    else:
        grid, kw = (1, 2), {"n_heads": 3, "n_kv_heads": 1}
    tc, params, batch, (one_m, one), (ref_m, ref) = _case(1, **kw)
    stand_in = types.SimpleNamespace(
        grid=as_grid(grid), coords={"data": 0, "model": 0},
        model=object(), data=None)
    lay = api.GridLayout(tc, stand_in)
    rules = make_rules(grid)
    rules.tree(api.param_specs(tc))
    if case == "kv_replicated":
        assert (lay.tp_heads, lay.tp_kv, lay.tp_mlp, lay.tp_vocab) == \
            (True, False, True, True)
        assert {d[0] for d in rules.dropped} == {"kv_heads"}
    else:
        assert (lay.tp_heads, lay.tp_kv, lay.tp_mlp) == (False, False, True)
        assert {d[0] for d in rules.dropped} == {"heads", "kv_heads"}
    got = grid_train_steps(world, grid, tc, params, batch, lr=LR)
    new = _hold_to_one_process(got, one_m, one)
    _hold_to_reference(new, got["metrics"], ref_m, ref, params)


def test_zero1_equals_the_replicated_world_bit_for_bit(world, tmp_path):
    """The Trainer on a (2, 1) grid (ZeRO-1 alone) and on the replicated
    world of two ranks: the same state under torch.equal, f32."""
    cfg = dataclasses.replace(tconfigs.get_reduced("llama3_2_3b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    run = TrainRunConfig(steps=3, global_batch=4, seq_len=16, lr=1e-2,
                         warmup=1, log_every=1, seed=1)
    rep = run_data_parallel(world, cfg, run, 2)
    zero = run_data_parallel(world, cfg, run, grid=(2, 1))
    assert [h["loss"] for h in rep["history"]] == \
        [h["loss"] for h in zero["history"]]
    a, b = dict(_flat(rep["state"])), dict(_flat(zero["state"]))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert zero["opt_bytes"][0] * 2 == rep["opt_bytes"][0]


def test_restart_onto_other_grids(world, tmp_path):
    """A checkpoint written on 2 x 2 restarts on 1 x 2 and on 4 x 1: the
    restored logical state has the saved bits."""
    cfg = dataclasses.replace(tconfigs.get_reduced("llama3_2_3b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    run = TrainRunConfig(steps=2, global_batch=4, seq_len=16, lr=1e-2,
                         warmup=1, log_every=1, seed=2,
                         ckpt_dir=str(tmp_path))
    saved = run_data_parallel(world, cfg, run, grid=(2, 2))["state"]
    want = dict(_flat(saved))
    for grid in ((1, 2), (4, 1)):
        got = restore_on_grid(world, grid, cfg, run)
        assert got["step"] == 2
        have = dict(_flat(got["state"]))
        assert have.keys() == want.keys()
        for k in want:
            assert np.array_equal(have[k], want[k]), (grid, k)


def test_grid_model_from_reference_weights(world):
    """``interop.lm_params_from_reference(..., comm=...)``: the forward of
    the rank's blocks on a 1 x 2 grid gives the rank's vocab columns of
    the one-process logits."""
    tc, params, batch, _, _ = _case(1)
    out = world.run_grid(_forward_columns, (1, 2), cfg=tc,
                         params=train_state_to_numpy({"p": params})["p"],
                         tokens=batch["tokens"])
    whole, _ = api.forward(api.build_model(tc, params), tc,
                           {"tokens": batch["tokens"]})
    got = torch.cat(out, dim=-1)
    assert torch.allclose(got, whole, rtol=0, atol=1e-12)


def _forward_columns(comm, device, *, cfg, params, tokens):
    model = lm_params_from_reference(params, cfg, device=device, comm=comm)
    with torch.no_grad():
        logits, _ = api.forward(model, cfg, {"tokens": tokens})
    return logits


@pytest.mark.parametrize("arch,mesh,cards,want", [
    ("llama3_2_3b", "auto", 4, (4, {"data": 1, "model": 4})),
    ("dbrx_132b", "auto", 4, (4, None)),
    ("mamba2_370m", "auto", 4, (4, {"data": 1, "model": 4})),
    ("llama3_2_3b", "auto", 1, (1, None)),
    ("dbrx_132b", "auto", 0, (1, None)),
    ("mamba2_370m", "2x1", 0, (2, {"data": 2, "model": 1})),
    ("llama3_2_3b", "2x2", 0, (4, {"data": 2, "model": 2})),
    ("dbrx_132b", "none", 4, (1, None)),
])
def test_launcher_layout(arch, mesh, cards, want):
    """``launch.train --mesh``: ``auto`` puts a family the grid runs on
    plan_mesh's grid (the dense decoder, the ssm family) and the others
    (MoE) on the 1-D data-parallel world of every card, as before the
    grid; one card or none is the single-device run."""
    from repro_torch.launch.train import choose_layout
    ranks, grid, why = choose_layout(tconfigs.get_reduced(arch), mesh, cards)
    assert (ranks, grid) == want
    assert ("ROADMAP" in why) == (mesh == "auto" and cards > 1
                                  and grid is None)


@pytest.mark.parametrize("arch,mesh", [("dbrx_132b", "2x2"),
                                       ("dbrx_132b", "2x1"),
                                       ("jamba_1_5_large_398b", "2x2")])
def test_launcher_refuses_a_grid_the_family_lacks(arch, mesh):
    """An explicit ``--mesh DxM`` the family does not run on raises
    before any rank starts (nothing runs replicated in its place)."""
    from repro_torch.launch.train import choose_layout, main
    with pytest.raises(ValueError, match="ROADMAP"):
        choose_layout(tconfigs.get_reduced(arch), mesh, 0)
    with pytest.raises(ValueError, match="ROADMAP"):
        main(["--arch", arch, "--mesh", mesh, "--device", "cpu",
              "--steps", "1"])


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "dbrx_132b",
                                  "jamba_1_5_large_398b",
                                  "jamba_1_5_large_398b:no-moe"])
def test_families_not_ported_to_a_grid_raise(arch):
    """MoE on any grid, and the hybrid family where 'model' > 1 (jamba's
    interleave with its MoE layers made dense: the family alone), raise
    naming the ROADMAP queue (nothing is replicated in their place); the
    ssm family is accepted (``tests/test_torch_grid_ssm.py``)."""
    name, _, variant = arch.partition(":")
    cfg = tconfigs.get_reduced(name)
    if variant == "no-moe":
        cfg = dataclasses.replace(cfg, moe=None)
    with pytest.raises(ValueError, match="ROADMAP"):
        api.check_grid_family(cfg, as_grid((1, 2)))
    if cfg.moe:
        with pytest.raises(ValueError, match="ROADMAP"):
            api.check_grid_family(cfg, as_grid((2, 1)))
    else:           # ZeRO-1 alone on a (D, 1) grid
        api.check_grid_family(cfg, as_grid((2, 1)))
    api.check_grid_family(tconfigs.get_reduced("llama3_2_3b"),
                          as_grid((2, 2)))


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llava_next_34b"])
def test_vlm_and_audio_accepted_on_a_grid(arch):
    """The vlm and the encoder-decoder train and serve on a grid (tensor
    parallelism over 'model', FSDP over 'data'): ``check_grid_family``
    accepts them on (1, 2) and (2, 2), with and without FSDP
    (``tests/test_torch_grid_families.py`` runs them)."""
    cfg = tconfigs.get_reduced(arch)
    for c in (cfg, dataclasses.replace(cfg, fsdp=True)):
        for grid in ((1, 2), (2, 2)):
            api.check_grid_family(c, as_grid(grid))


def test_error_terms_and_digests_on_the_ranks(world):
    """The phase-16 helpers: the errors computed on the ranks' blocks
    against another run (here the one-process run itself: zero up to
    1e-10), and ZeRO-1's blocks against the replicated world's by digest
    (the same bits)."""
    from repro_torch.launch.grid_train import zero1_against_replicated
    tc, params, batch, (one_m, one), _ = _case(1)
    _, state, _ = one_process_steps(tc, params, batch, lr=LR)
    got = grid_train_steps(world, (2, 2), tc, params, batch, lr=LR,
                           keep=False, want={k: state["opt"][k]
                                             for k in ("master", "m")})
    assert got["state"] is None and len(got["err"]) == 2 * len(
        list(_flat(params)))
    assert max(got["err"].values()) <= GRID_TOL
    cfg = dataclasses.replace(tconfigs.get_reduced("llama3_2_3b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    run = TrainRunConfig(steps=2, global_batch=4, seq_len=16, lr=1e-2,
                         warmup=1, log_every=1, seed=4)
    outs = zero1_against_replicated(world, (4, 1), cfg, run)
    for o in outs:
        assert o["replicated"]["digests"] == o["grid"]["digests"]
        assert o["grid"]["opt_bytes"] * 4 == o["replicated"]["opt_bytes"]
        end = dict(o["grid"]["digests"])
        assert o["grid"]["start"] and all(
            d != end[k] for k, d in o["grid"]["start"])


def _tapped_step(comm, device, *, cfg, params, batch):
    from repro_torch.core.collectives import WireTap
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import place_fresh
    state = place_fresh(params, cfg, comm)
    step = make_train_step(cfg, AdamWConfig(lr=LR), 1, comm)
    comm.reset()
    with WireTap() as tap:
        step(state, batch)
    return comm.counters(), tap.counters()


def test_wire_tap_sees_the_grid_collectives(world):
    """Every collective of a grid step (forward and backward, over each
    group) is one ``Comm`` counts and a ``WireTap`` sees: all-reduces,
    FSDP's all-gathers and reduce-scatters."""
    tc, params, batch, _, _ = _case(1)
    tc = dataclasses.replace(tc, fsdp=True)
    for counters, tap in world.run_grid(_tapped_step, (2, 2), cfg=tc,
                                        params=params, batch=batch):
        total = {k: sum(c[k] for c in counters.values()) for k in (
            "all_reduces", "all_gathers", "gather_words",
            "reduce_scatters", "rs_words", "max_reduces")}
        assert total["reduce_scatters"] > 0 and total["max_reduces"] == 1
        assert tap["all_reduces"] == total["all_reduces"]
        assert tap["max_reduces"] == total["max_reduces"]
        assert tuple(tap["other"]["all_gather"]) == \
            (total["all_gathers"], total["gather_words"])
        assert tuple(tap["other"]["reduce_scatter"]) == \
            (total["reduce_scatters"], total["rs_words"])


def test_f32_spread_on_a_small_model():
    """``launch.f32_spread`` (the one-process witness of how far f32 alone
    spreads a step): at a reduced width, f32 against f64 within f32's
    rounding, the regrouped run's loss not compared (other rows), every
    leaf's error read."""
    from repro_torch.launch.f32_spread import spread, worst
    cfg = tconfigs.get_reduced("llama3_2_3b")
    out = spread(cfg, (4, 32), 0, torch.device("cpu"))
    e = out["f32_vs_f64"]
    assert e["loss"] < 1e-5 and e["grad_norm"] < 1e-4
    assert worst(e, "m")[1] < 1e-3 and worst(e, "move")[1] < 2e-2
    assert out["regrouped_vs_f32"]["loss"] is None
    assert worst(out["regrouped_vs_f32"], "m")[1] < 1e-3
    from repro_torch.models.module import tree_leaves
    assert len(e) == 2 + 2 * len(tree_leaves(api.param_specs(cfg)))
