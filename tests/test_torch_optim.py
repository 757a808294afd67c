"""The port's optimizer, train step and training driver
(``repro_torch.optim``, ``repro_torch.train``, ``launch/train.py``)
against the reference's, on the CPU, on the same numpy trees and the
reference's weights (``interop.train_state_from_reference``).

Tolerances:
* ``cosine_warmup``: rtol 1e-6 (f32 on both sides; XLA's and ATen's cos
  may round one f32 ulp apart, 6e-8 relative);
* ``adamw_update`` on identical trees: rtol / atol 2e-6 on the f32 master,
  m and v (each element's few f32 operations, rounded by XLA and ATen in
  their own ways: a few ulps), the bf16 parameters within one bf16 ulp
  of the reference's (a master a few f32 ulps away can round to the next
  bf16 value), grad_norm and lr rtol 1e-6;
* the train step on the reference's weights, f32: the two packages'
  gradients differ by the reference's own f32 rounding (per leaf up to
  6.6e-5 of its norm, ``test_torch_train.py``), so the loss is held at
  atol 1e-5, m and v at rtol 5e-4 of each leaf's norm, and each leaf's
  move (master after - before) at 2e-3 of its norm: Adam's first step
  moves an element by about lr * sign(g), so the few elements whose
  gradient is within rounding of 0 can step the other way;
* the 5-step loss trajectory through the shared stream: atol 1e-4 on
  losses of about 6;
* resume: ``torch.equal`` on every leaf and the stream's cursor;
* one train step with the experts sharded over 2 and 4 ranks (phi3.5 and
  dbrx reduced at capacity 1.0: slots drop) against the reference's on the
  global batch at the tolerances above (the aux loss rtol 1e-5; dbrx's
  first-layer wk move at 2e-2, where the port's one-rank step also reads
  1.7e-2), and each master leaf's move against the port's one-rank step
  at 2e-4 (read: up to 7.3e-5);
* the elastic run on two gloo ranks against one rank, (loss atol, each
  leaf's move of the f32 master after 4 steps against its norm): bf16
  (1e-2, 0.15) -- two ranks sum two bf16 gradients where one rank rounds
  one, and Adam's normalised step turns a gradient element within
  rounding of 0 into a move of lr either way (read, seeds 0-2, 4 -> 2 and
  2 -> 1 ranks: up to 3.4e-3 and 5.2e-2) --; f32 (1e-5, 2e-4) (read: up
  to 9.5e-7 and 1.8e-5).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import TokenStream as JStream
from repro.models import api as japi
from repro.models import init_params as jinit
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_update as j_adamw_update
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim.schedules import cosine_warmup as j_cosine
from repro.train import make_train_step as j_make_train_step
import repro_torch.configs as tconfigs
from repro_torch.core import SolverWorld
from repro_torch.data import TokenStream
from repro_torch.interop import (train_state_from_reference,
                                 train_state_to_numpy)
from repro_torch.optim import (AdamWConfig, adamw_update, cosine_warmup,
                               init_opt_state, opt_state_specs)
from repro_torch.models import api
from repro_torch.models.module import ParamSpec, tree_leaves
from repro_torch.train import (Trainer, TrainRunConfig, make_train_step,
                               run_data_parallel, train_state_specs)

from test_torch_train import _batch

SCHED_TOL = 1e-6
OPT_TOL = 2e-6
BF16_ULP = 2.0 ** -7           # relative spacing of bf16 values in [1, 2)
STEP_LOSS_TOL = 1e-5
MOMENT_TOL = 5e-4
MOVE_TOL = 2e-3
TRAJ_TOL = 1e-4
ELASTIC_TOL = {"bf16": (1e-2, 0.15), "f32": (1e-5, 2e-4)}
# experts sharded over ranks against the port's one-rank step: each
# master leaf's move (read: at most 7.3e-5, dbrx on 4 ranks)
EP_MOVE_TOL = 2e-4
# dbrx reduced's first-layer wk: the port's one-rank step is itself 1.7e-2
# from the reference's move (Adam's first step turns a gradient element
# within rounding of 0 into a move of lr either way; its m holds
# MOMENT_TOL), and so are the ranks'
MOVE_TOL_LEAF = {("dbrx_132b", "sub0/attn/wk"): 2e-2}
ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, dtype=np.float64)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("warmup,total", [(20, 200), (1, 10), (0, 5)])
def test_cosine_warmup_matches_reference(warmup, total):
    got, want = cosine_warmup(3e-4, warmup, total), j_cosine(3e-4, warmup,
                                                              total)
    for step in sorted({0, max(warmup - 1, 0), warmup, warmup + 1,
                        (warmup + total) // 2, total, total + 7}):
        g, w = got(step), want(step)
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=SCHED_TOL,
                                   atol=0, err_msg=str(step))
    # a tensor step on the step's device, as the train step passes it
    assert got(torch.tensor(3, dtype=torch.int32)).device.type == "cpu"


def _trees(scale, seed=0):
    """params {w: bf16 (6, 5), isl: f32 (7,) (an f32 island)}, grads of
    ``scale``, an optimizer state after a few steps (nonzero m, v)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    isl = rng.standard_normal(7).astype(np.float32)
    gw = (scale * rng.standard_normal((6, 5))).astype(np.float32)
    gi = (scale * rng.standard_normal(7)).astype(np.float32)
    m = {"w": (0.01 * rng.standard_normal((6, 5))).astype(np.float32),
         "isl": (0.01 * rng.standard_normal(7)).astype(np.float32)}
    v = {k: (1e-4 * rng.random(x.shape)).astype(np.float32)
         for k, x in m.items()}
    master = {"w": w + (1e-3 * rng.standard_normal((6, 5))).astype(
        np.float32), "isl": isl}
    return {"w": w, "isl": isl}, {"w": gw, "isl": gi}, master, m, v


@pytest.mark.parametrize("scale,clipped", [(10.0, True), (0.01, False)])
@pytest.mark.parametrize("step", [0, 5])
def test_adamw_update_matches_reference(scale, clipped, step):
    p, g, master, m, v = _trees(scale)
    cfg_kw = dict(lr=cosine_warmup(1e-3, 2, 20), weight_decay=0.1,
                  grad_clip=1.0)
    jp = {"w": jnp.asarray(p["w"], jnp.bfloat16), "isl": jnp.asarray(p["isl"])}
    jg = {"w": jnp.asarray(g["w"], jnp.bfloat16), "isl": jnp.asarray(g["isl"])}
    jopt = {"master": jax.tree.map(jnp.asarray, master),
            "m": jax.tree.map(jnp.asarray, m),
            "v": jax.tree.map(jnp.asarray, v)}
    jcfg = JAdamW(**dict(cfg_kw, lr=j_cosine(1e-3, 2, 20)))
    wp, wopt, wm = jax.jit(lambda a, b, c, s: j_adamw_update(a, b, c, s,
                                                             jcfg))(
        jp, jg, jopt, jnp.int32(step))

    tp = {"w": torch.from_numpy(p["w"]).bfloat16(),
          "isl": torch.from_numpy(p["isl"])}
    tg = {"w": torch.from_numpy(g["w"]).bfloat16(),
          "isl": torch.from_numpy(g["isl"])}
    topt = {k: {n: torch.from_numpy(a.copy()) for n, a in t.items()}
            for k, t in (("master", master), ("m", m), ("v", v))}
    ids = [id(t) for t in (tp["w"], topt["master"]["w"], topt["v"]["isl"])]
    gp, gopt, gm = adamw_update(tp, tg, topt, torch.tensor(step,
                                                           dtype=torch.int32),
                                AdamWConfig(**cfg_kw))
    assert gp is tp and gopt is topt          # updated in place
    assert [id(t) for t in (tp["w"], topt["master"]["w"],
                            topt["v"]["isl"])] == ids
    assert tp["w"].dtype == torch.bfloat16 and tp["isl"].dtype == \
        torch.float32
    gnorm = float(wm["grad_norm"])
    assert (gnorm > 1.0) == clipped
    np.testing.assert_allclose(float(gm["grad_norm"]), gnorm, rtol=1e-6)
    np.testing.assert_allclose(float(gm["lr"]), float(wm["lr"]), rtol=1e-6)
    for k in ("master", "m", "v"):
        for n in ("w", "isl"):
            np.testing.assert_allclose(gopt[k][n].numpy(),
                                       np.asarray(wopt[k][n]), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=f"{k}/{n}")
    np.testing.assert_allclose(tp["isl"].numpy(), np.asarray(wp["isl"]),
                               rtol=OPT_TOL, atol=OPT_TOL)
    want_w = np.asarray(wp["w"], np.float32)
    np.testing.assert_allclose(tp["w"].float().numpy(), want_w,
                               rtol=BF16_ULP, atol=0)


def test_opt_state_specs_and_init():
    specs = {"a": ParamSpec((3, 4), ("x", "y"), torch.bfloat16, scale=0.5),
             "b": {"c": ParamSpec((2,), ("x",), torch.float32, init="ones")}}
    o = opt_state_specs(specs)
    assert o["master"]["a"] == ParamSpec((3, 4), ("x", "y"), torch.float32,
                                         scale=0.5)
    assert o["m"]["b"]["c"] == ParamSpec((2,), ("x",), torch.float32,
                                         init="zeros")
    p = {"a": torch.randn(3, 4).bfloat16(), "b": {"c": torch.ones(2)}}
    st = init_opt_state(p)
    assert torch.equal(st["master"]["a"], p["a"].float())
    assert st["master"]["b"]["c"] is not p["b"]["c"]    # a copy
    assert not st["v"]["a"].any() and st["m"]["a"].dtype == torch.float32


def _f32(get, arch):
    cfg = get(arch)
    f32 = torch.float32 if get is tconfigs.get_reduced else jnp.float32
    return dataclasses.replace(cfg, dtype=f32, param_dtype=f32)


def _shared_state(arch="llama3_2_3b", seed=0):
    jc, tc = (_f32(jconfigs.get_reduced, arch),
              _f32(tconfigs.get_reduced, arch))
    params = jinit(japi.param_specs(jc), jax.random.key(seed))
    jstate = {"params": params, "opt": j_init_opt_state(params),
              "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_reference(jax.tree.map(np.asarray, jstate), tc,
                                        device="cpu")
    return jc, jstate, tc, tstate


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jc, jstate, tc, tstate = _shared_state()
    batch = TokenStream(tc.vocab, 32, 4, seed=3).batch_at(0)
    batch["mask"][1, 20:] = 0.0                  # a masked tail
    start = train_state_to_numpy(tstate)
    jstep = jax.jit(j_make_train_step(jc, JAdamW(lr=1e-3), microbatches))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, AdamWConfig(lr=1e-3), microbatches)(
        tstate, batch)
    assert tnew is tstate and int(tnew["step"]) == 1
    assert tm.keys() == jm.keys() == {"loss", "ppl_log", "grad_norm", "lr"}
    for k in ("loss", "ppl_log"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=STEP_LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=MOMENT_TOL)
    got = dict(_leaves(train_state_to_numpy(tnew)))
    want = dict(_leaves(jax.tree.map(np.asarray, jnew)))
    before = dict(_leaves(start))
    assert got.keys() == want.keys()
    for k in want:
        if k[0] == "opt" and k[1] in ("m", "v"):
            assert _rel(got[k], want[k]) < MOMENT_TOL, k
        elif k[0] != "step":
            assert _rel(got[k] - before[k], want[k] - before[k]) < \
                MOVE_TOL, k


def test_loss_trajectory_matches_reference():
    """Five steps from the reference's weights on the shared stream (the
    cosine-warmup schedule, two microbatches): the losses agree."""
    jc, jstate, tc, tstate = _shared_state(seed=1)
    kw = dict(vocab=tc.vocab, seq_len=32, global_batch=4, seed=5)
    sched = dict(base_lr=1e-3, warmup=2, total=5)
    jstep = jax.jit(j_make_train_step(
        jc, JAdamW(lr=j_cosine(**sched)), 2))
    tstep = make_train_step(tc, AdamWConfig(lr=cosine_warmup(**sched)), 2)
    js, ts = JStream(**kw), TokenStream(**kw)
    jl, tl = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in next(js).items()})
        tstate, tm = tstep(tstate, next(ts))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TRAJ_TOL)
    assert tl[-1] < tl[0]
    assert int(tstate["step"]) == 5 and ts.step == js.step == 5


def test_train_state_specs_match_reference():
    from repro.train import train_state_specs as j_specs
    tc, jc = tconfigs.get_reduced("mamba2_370m"), \
        jconfigs.get_reduced("mamba2_370m")
    got, want = train_state_specs(tc), j_specs(jc)

    def flat(tree, name, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], name, path + (k,))
        else:
            yield path, (tuple(tree.shape), name(tree.dtype), tree.init)

    assert dict(flat(got, lambda d: str(d).split(".")[-1])) == \
        dict(flat(want, lambda d: jnp.dtype(d).name))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_one_train_step(arch):
    cfg = tconfigs.get_reduced(arch)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(api.param_specs(cfg), gen)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    before = [p.clone() for p in tree_leaves(params,
                                             is_leaf=torch.is_tensor)]
    batch = _batch(cfg, 2, 64, seed=0, masked=False)
    new, metrics = make_train_step(cfg, AdamWConfig(lr=1e-3))(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(
        before, tree_leaves(new["params"], is_leaf=torch.is_tensor)))


def _run_cfg(tmp, **kw):
    return TrainRunConfig(**{**dict(steps=4, global_batch=4, seq_len=16,
                                    lr=1e-3, warmup=1, ckpt_dir=str(tmp),
                                    save_every=2, log_every=1), **kw})


def _equal_trees(a, b) -> bool:
    la = tree_leaves(a, is_leaf=torch.is_tensor)
    lb = tree_leaves(b, is_leaf=torch.is_tensor)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_trainer_resumes_exactly(tmp_path):
    cfg = tconfigs.get_reduced("llama3_2_3b")          # bf16
    straight = Trainer(cfg, _run_cfg(tmp_path / "a"), device="cpu")
    straight.run()
    first = Trainer(cfg, _run_cfg(tmp_path / "b", steps=2), device="cpu")
    first.run()
    resumed = Trainer(cfg, _run_cfg(tmp_path / "b"), device="cpu")
    assert int(resumed.state["step"]) == 2 and resumed.stream.step == 2
    resumed.run()
    assert int(resumed.state["step"]) == 4
    assert resumed.stream.step == straight.stream.step == 4
    assert _equal_trees(resumed.state, straight.state)
    assert resumed.ckpt.all_steps() == [2, 4]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_elastic_ranks_match_one_rank(tmp_path, dtype):
    """Two steps on two gloo ranks with a checkpoint, then a restore on one
    rank of the same world to step 4, against one Trainer on the same
    stream; the replicas are the same bytes on both ranks.  The same
    restart of an MoE config (phi3.5 reduced at capacity 1.25, its four
    experts two a rank on two ranks) against its one-rank Trainer."""
    cfg = tconfigs.get_reduced("granite_3_2b")         # bf16
    if dtype == "f32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
    tol_loss, tol_move = ELASTIC_TOL[dtype]
    moe = tconfigs.get_reduced("phi3_5_moe_42b")
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=1.25))
    if dtype == "f32":
        moe = dataclasses.replace(moe, dtype=torch.float32,
                                  param_dtype=torch.float32)
    for c, sub in ((cfg, "dense"), (moe, "moe")):
        one = Trainer(c, _run_cfg(None, ckpt_dir=None), device="cpu")
        hist_one = one.run()
        with SolverWorld(2, device="cpu", kernels=False) as world:
            out2 = run_data_parallel(world, c,
                                     _run_cfg(tmp_path / sub, steps=2))
            assert len(out2["digests"]) == 2
            out1 = run_data_parallel(world, c, _run_cfg(tmp_path / sub),
                                     n_ranks=1)
        state = out1["state"]
        assert int(state["step"]) == 4
        hist = out2["history"] + out1["history"]
        assert [h["step"] for h in hist] == [1, 2, 3, 4]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in hist_one], rtol=0,
                                   atol=tol_loss)
        start = one._fresh_state()["opt"]["master"]
        for a, b, s0 in zip(*(tree_leaves(t, is_leaf=torch.is_tensor)
                              for t in (state["opt"]["master"],
                                        one.state["opt"]["master"], start))):
            err = float(torch.linalg.norm(a - b) / torch.linalg.norm(b - s0))
            assert err < tol_move, (sub, err)


def test_moe_refused_on_ranks():
    """MoE training on ranks shards the experts: a world whose size does
    not divide E is refused (phi3.5 reduced: E = 4)."""
    class Three:
        size, rank = 3, 0
    with pytest.raises(ValueError, match="E=4 .* P=3"):
        make_train_step(tconfigs.get_reduced("phi3_5_moe_42b"),
                        AdamWConfig(), comm=Three())


@pytest.fixture(scope="module")
def moe_world():
    with SolverWorld(4, device="cpu", kernels=False) as world:
        yield world


_MOE_REFERENCE = {}


def _moe_reference_step(arch):
    """The reference's jitted step on its weights at capacity 1.0 (slots
    drop), f32, on a global batch of 4 rows: (the port's cfg and state,
    the batch, the reference's new state and metrics)."""
    if arch not in _MOE_REFERENCE:
        jc, jstate, tc, tstate = _shared_state(arch)
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=1.0))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=1.0))
        batch = TokenStream(tc.vocab, 32, 4, seed=3).batch_at(0)
        batch["mask"][1, 20:] = 0.0
        jnew, jm = jax.jit(j_make_train_step(jc, JAdamW(lr=1e-3)))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        one = jax.tree.map(lambda t: t.clone(), tstate)
        one, _ = make_train_step(tc, AdamWConfig(lr=1e-3))(one, batch)
        _MOE_REFERENCE[arch] = (tc, tstate, batch,
                                jax.tree.map(np.asarray, jnew),
                                {k: float(v) for k, v in jm.items()},
                                train_state_to_numpy(one))
    return _MOE_REFERENCE[arch]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "dbrx_132b"])
def test_moe_train_step_on_ranks_matches_reference(moe_world, arch, P):
    """One train step with the experts sharded over P gloo ranks (each
    its rows of the global batch, one global dispatch) against the
    reference's jitted step on the global batch at a capacity that drops
    slots: the loss, the aux loss, the grad norm and every updated leaf
    (the shards joined), at the one-rank step's tolerances; each master
    leaf's move also against the port's one-rank step (EP_MOVE_TOL)."""
    from repro_torch.launch.expert_parallel import ep_train_step
    tc, tstate, batch, want, jm, one = _moe_reference_step(arch)
    model = api.build_model(tc, tstate["params"])
    with torch.no_grad():
        _, aux = api.forward(model, tc, batch)
    assert float(aux["moe_drop_frac"]) > 0            # slots dropped
    got = ep_train_step(moe_world.ranks(P), tc, tstate["params"], batch, P,
                        lr=1e-3, keep=True)
    assert got["forward"]["moe_drop_frac"] == float(aux["moe_drop_frac"])
    tm = got["metrics"]
    assert tm.keys() == jm.keys() == {"loss", "ppl_log", "moe_aux_loss",
                                      "grad_norm", "lr"}
    for k in ("loss", "ppl_log"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=STEP_LOSS_TOL)
    np.testing.assert_allclose(tm["moe_aux_loss"], jm["moe_aux_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                               rtol=MOMENT_TOL)
    assert all(c["all_to_alls"] == 4 * tc.n_layers for c in got["counters"])
    new = dict(_leaves(train_state_to_numpy(got["state"])))
    ref = dict(_leaves(want))
    one = dict(_leaves(one))
    before = dict(_leaves(train_state_to_numpy(tstate)))
    assert new.keys() == ref.keys() == one.keys()
    for k in ref:
        if k[0] == "opt" and k[1] in ("m", "v"):
            assert _rel(new[k], ref[k]) < MOMENT_TOL, k
        elif k[0] != "step":
            tol = MOVE_TOL_LEAF.get((arch, "/".join(k[-3:])), MOVE_TOL)
            assert _rel(new[k] - before[k], ref[k] - before[k]) < tol, k
            assert _rel(new[k] - before[k], one[k] - before[k]) < \
                EP_MOVE_TOL, k


def test_launch_train_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--preset",
         "cpu-small", "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ckpt")], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "[train] loss" in proc.stdout
    assert (tmp_path / "ckpt" / "LATEST").exists()


def test_train_lm_names_a_preset_and_a_checkpoint(monkeypatch):
    from repro_torch.launch import train_lm
    seen = []
    monkeypatch.setattr(train_lm, "main", lambda argv: seen.append(argv))
    train_lm.run(["--device", "cpu"])
    train_lm.run(["--preset", "100m", "--ckpt-dir", "x"])
    assert seen == [["--device", "cpu", "--preset", "cpu-small",
                     "--ckpt-dir", "train_lm_ckpt"],
                    ["--preset", "100m", "--ckpt-dir", "x"]]
