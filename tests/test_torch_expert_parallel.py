"""Experts sharded over ranks (``models.moe`` with ``comm``,
``launch/expert_parallel.py``) against the reference's single global
dispatch, on one module world of four gloo CPU ranks (E = 4 experts, P in
{2, 4} through ``world.ranks(P)``), inputs made from numpy seeds.

Tolerances:
* the block against ``repro.models.moe.moe_block`` on the concatenated
  batch, f32: routing is discrete and must agree exactly (the same drop
  fraction); outputs atol / rtol 1e-5 (``test_torch_moe.py``'s); the aux
  loss rtol 1e-5 (a sum of the ranks' probability sums over the tokens
  against the reference's mean: a few f32 ulps);
* the block against the port's single-rank block: ``torch.equal`` for the
  output and the drop fraction in f32 and f64 (the same ops in the same
  order: the experts' ``bmm`` on an (E / P, C, D) slice of the buffers
  gives the (E, C, D) call's bits here), the aux loss 1e-6 in f32 and
  1e-14 in f64 relative, the gradients 1e-12 relative in f64, the f32
  router's 1e-6 (its partial sums meet in another order: read 9.1e-8);
* replicated-token decode (prefill + decode steps on the ranks) against
  the reference's ``forward``: atol 3e-3 (``test_torch_decode.py``'s),
  and against the port's one-rank decode ``torch.equal``;
* the engine on the ranks: the one-rank engine's greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import MoEConfig as JMoE
from repro.models import api as japi
from repro.models import init_params as jinit
from repro.models import moe as JMOE
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.analysis.contract_pass import _check_record
from repro_torch.configs import MoEConfig, get_reduced
from repro_torch.core import SolverWorld
from repro_torch.core.collectives import collective_summary
from repro_torch.interop import join_expert_shards, lm_params_from_reference
from repro_torch.launch import expert_parallel as EP
from repro_torch.models import api
from repro_torch.models import moe as TMOE
from repro_torch.serve import Engine, ServeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step, train_state_specs

from test_torch_models import LOGIT_TOL, shared_model

OUT_TOL = 1e-5
AUX_TOL = 1e-5
ROUTER_GRAD_TOL = 1e-6      # the router is f32 in every model
EXPERTS = 4


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False) as w:
        yield w


def _setup(capacity_factor, groups=1, d=32, f=64, tokens=(8, 8), seed=0):
    """The reference's block weights (its init on ``moe_specs``) and a
    numpy batch, with a hot expert (an offset on the tokens meets a skew
    of the router) so that capacity 1.25 drops slots."""
    moe = {"num_experts": EXPERTS, "top_k": 2,
           "capacity_factor": capacity_factor, "groups": groups}
    jc = dataclasses.replace(j_reduced("phi3_5_moe_42b"), d_model=d, d_ff=f,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             moe=JMoE(**moe))
    tc = dataclasses.replace(get_reduced("phi3_5_moe_42b"), d_model=d,
                             d_ff=f, dtype=torch.float32,
                             param_dtype=torch.float32, moe=MoEConfig(**moe))
    pj = jinit(JMOE.moe_specs(jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    pj["router"] = pj["router"] + jnp.asarray(
        np.linspace(0.15, -0.15, EXPERTS, dtype=np.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = (rng.standard_normal((*tokens, d)) + 0.5).astype(np.float32)
    return jc, tc, pj, pt, x


def _f64(tc, pt, x):
    cfg = dataclasses.replace(tc, dtype=torch.float64,
                              param_dtype=torch.float64)
    p = {k: (v if k == "router" else v.double()) for k, v in pt.items()}
    return cfg, p, torch.from_numpy(x).double()


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_block_matches_reference(world, capacity_factor, groups, P):
    """The expert-parallel block (each rank its rows) against the
    reference's one dispatch over the concatenated batch, f32."""
    jc, tc, pj, pt, x = _setup(capacity_factor, groups)
    outj, mj = JMOE.moe_block(pj, jnp.asarray(x), jc)
    got = EP.ep_block(world.ranks(P), tc, pt, torch.from_numpy(x), P)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(outj),
                               rtol=OUT_TOL, atol=OUT_TOL)
    m = got["metrics"]
    assert float(m["moe_drop_frac"]) == float(mj["moe_drop_frac"])
    assert (float(m["moe_drop_frac"]) > 0) == (capacity_factor < 2)
    np.testing.assert_allclose(float(m["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=AUX_TOL)
    for c in (cs[0] for cs in got["counters"]):
        assert (c["all_to_alls"], c["all_gathers"], c["all_reduces"]) == \
            (2, 1, 1)


@pytest.mark.parametrize("replicated", [False, True],
                         ids=["sharded", "replicated"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_block_equals_one_rank(world, dtype, P, replicated):
    """Against the port's single-rank block on the same weights and
    tokens: the output and the drop fraction the same bits; in f64 the
    gradients of sum(out * dy) + aux (the ranks' aux / P each) too, within
    rounding."""
    _, tc, _, pt, x = _setup(1.25, groups=2)
    xt = torch.from_numpy(x)
    if dtype == "f64":
        tc, pt, xt = _f64(tc, pt, x)
    want, wm = TMOE.moe_block(pt, xt, tc)
    dy = None
    if dtype == "f64" and not replicated:
        dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
            xt.shape))
    got = EP.ep_block(world.ranks(P), tc, pt, xt, P, replicated=replicated,
                      dy=dy)
    assert torch.equal(got["out"], want)
    assert torch.equal(got["metrics"]["moe_drop_frac"], wm["moe_drop_frac"])
    assert float(wm["moe_drop_frac"]) > 0
    rel = 1e-14 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(float(got["metrics"]["moe_aux_loss"]),
                               float(wm["moe_aux_loss"]), rtol=rel)
    if dy is None:
        return
    p1 = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x1 = xt.clone().requires_grad_()
    out, m = TMOE.moe_block(p1, x1, tc)
    ((out * dy).sum() + m["moe_aux_loss"]).backward()
    want_g = {"x": x1.grad, **{k: v.grad for k, v in p1.items()}}
    for k, g in got["grads"].items():
        err = float(torch.linalg.norm(g - want_g[k])
                    / torch.linalg.norm(want_g[k]))
        assert err < (ROUTER_GRAD_TOL if k == "router" else 1e-12), (k, err)


def test_rank_local_dispatch_would_differ(world):
    """The witness: on this batch a data-parallel rank dispatching its own
    rows alone (its capacity from its tokens) drops another share of the
    slots than the global dispatch, which the ranks reproduce."""
    _, tc, _, pt, x = _setup(1.25)
    xt = torch.from_numpy(x)
    _, wm = TMOE.moe_block(pt, xt, tc)
    got = EP.ep_block(world.ranks(4), tc, pt, xt, 4)
    assert torch.equal(got["metrics"]["moe_drop_frac"], wm["moe_drop_frac"])
    local = [TMOE.moe_block(pt, xs, tc)[1] for xs in xt.chunk(4)]
    local_drop = float(np.mean([float(m["moe_drop_frac"]) for m in local]))
    assert local_drop != float(wm["moe_drop_frac"])


@pytest.mark.parametrize("arch,P", [("phi3_5_moe_42b", 4), ("dbrx_132b", 4),
                                    ("jamba_1_5_large_398b", 2)])
def test_replicated_decode_matches_reference(world, arch, P):
    """Prefill of S - 3 tokens and 3 decode steps fed the batch's next
    tokens, every rank holding E / P experts and the same tokens, against
    the reference's forward at those positions, and the port's one-rank
    decode bit for bit."""
    jc, params, tc, model = shared_model(arch)
    B, S, steps = 2, 24, 3
    toks = np.random.default_rng(3).integers(0, tc.vocab, (B, S)).astype(
        np.int32)
    want, _ = japi.forward(params, jc, {"tokens": jnp.asarray(toks)})
    want = np.asarray(want)
    prompt = torch.from_numpy(toks[:, :S - steps])
    feed = torch.from_numpy(toks[:, S - steps:])
    got = EP.ep_decode(world.ranks(P), tc, model.param_tree(), prompt,
                       steps, S, P, feed=feed)
    one = EP.decode(model, tc, prompt, steps, S, feed=feed)
    assert torch.equal(got["logits"], one["logits"])
    assert torch.equal(got["prefill"], one["prefill"])
    assert got["all_gathers"] == [tc.n_layers // tc.moe.every_n_layers] * \
        steps
    np.testing.assert_allclose(got["prefill"].numpy(),
                               want[:, S - steps - 1], rtol=0,
                               atol=LOGIT_TOL)
    for i in range(steps):
        np.testing.assert_allclose(got["logits"][i].numpy(),
                                   want[:, S - steps + i], rtol=0,
                                   atol=LOGIT_TOL)


def test_first_difference_traces_every_moe_tensor(world):
    """The trace behind phase 15b's bits gate: dbrx reduced, prefill and 2
    fed steps on 4 ranks against one process, every MoE call's input,
    router probabilities, selection, expert outputs (each rank's rows of
    the one process's buffer), slots and combined rows, then the logits; on
    the CPU every one equal, so no first difference."""
    _, _, tc, model = shared_model("dbrx_132b")
    B, S, steps = 2, 24, 2
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tc.vocab, (B, S)).astype(np.int64))
    out = EP.first_difference(world.ranks(4), tc, model.param_tree(), model,
                              toks[:, :S - steps], steps, S, 4,
                              feed=toks[:, S - steps:])
    calls = tc.n_layers // tc.moe.every_n_layers * (1 + steps)
    names = ["input", "router probs", "selection", "expert outputs",
             "expert slots", "combined"]
    assert [name for _, name, _, _ in out["records"]] == (
        names * calls + ["prefill logits", "decode logits"])
    assert [c for c, *_ in out["records"][:-2]] == [
        1 + i // len(names) for i in range(len(names) * calls)]
    assert out["first"] is None
    assert all(eq and diff == 0.0 for _, _, eq, diff in out["records"])


def test_engine_on_ranks_equals_one_rank(world):
    """``Engine(..., comm=...)`` on two ranks, each holding two of the
    four experts, every rank given the same requests: the one-rank
    engine's greedy tokens."""
    _, _, tc, model = shared_model("phi3_5_moe_42b")
    prompts = [[5, 9, 13, 2, 7], [200, 3, 44], [17] * 9]
    serve = ServeConfig(max_seq=64, slots=2, min_bucket=8)
    want = Engine(tc, model, serve).generate(prompts, 6)
    got = EP.ep_serve(world.ranks(2), tc, model.param_tree(), prompts, 6,
                      serve, 2)
    assert got == want


def test_reference_weights_cut_and_joined_back():
    """The reference's dbrx weights cut into four ranks' expert shards
    (``lm_params_from_reference(..., expert_shard)``) and joined back are
    the same bytes; each shard holds E / 4 experts of every MoE leaf."""
    jc = j_reduced("dbrx_132b")
    tc = get_reduced("dbrx_132b")
    params = jax.tree.map(np.asarray, jinit(japi.param_specs(jc),
                                            jax.random.key(2)))
    shards = [lm_params_from_reference(params, tc, device="cpu",
                                       expert_shard=(r, 4)).param_tree()
              for r in range(4)]
    assert shards[0]["blocks"]["sub0"]["moe"]["w1"].shape[1] == EXPERTS // 4
    whole = lm_params_from_reference(params, tc, device="cpu").param_tree()
    joined = join_expert_shards(shards)

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], path + (k,))
        else:
            yield path, tree
    for (pa, a), (pb, b) in zip(flat(joined), flat(whole)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


@pytest.mark.parametrize("arch", ["dbrx_132b", "jamba_1_5_large_398b"])
def test_init_model_shards_join_into_the_one_rank_model(arch):
    """``init_model(..., expert_shard=(r, 2))`` draws the expert-by-expert
    stream and keeps the rank's experts: the two shards joined are the
    one-rank model's weights from that stream (``expert_shard=(0, 1)``),
    the same bytes."""
    cfg = get_reduced(arch)
    whole = api.init_model(cfg, torch.Generator().manual_seed(7),
                           expert_shard=(0, 1))
    shards = [api.init_model(cfg, torch.Generator().manual_seed(7),
                             expert_shard=(r, 2)).param_tree()
              for r in range(2)]
    got = join_expert_shards(shards)
    want = whole.param_tree()

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], path + (k,))
        else:
            yield path, tree
    for (pa, a), (pb, b) in zip(flat(got), flat(want)):
        assert pa == pb and torch.equal(a, b), pa


def test_train_state_gathered_from_ranks_equals_reference(world):
    """A reference train state cut into four ranks' shards
    (``train_state_from_reference(..., expert_shard)``) and gathered back
    (``train_state_to_numpy(state, comm)``): rank 0 holds the
    reference's whole tree, the same bytes, the other ranks nothing."""
    jc = dataclasses.replace(j_reduced("phi3_5_moe_42b"), dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tc = dataclasses.replace(get_reduced("phi3_5_moe_42b"),
                             dtype=torch.float32, param_dtype=torch.float32)
    params = jinit(japi.param_specs(jc), jax.random.key(4))
    opt = j_init_opt_state(params)
    opt = {"master": opt["master"], "v": opt["v"],
           "m": jax.tree.map(lambda t: t + 0.5, opt["m"])}
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                      "step": jnp.int32(3)})
    tree, *others = EP.gathered_state(world.ranks(4), tc, state, 4)
    assert others == [None] * 3

    def check(got, want, path=()):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                check(got[k], want[k], path + (k,))
        else:
            assert got.shape == want.shape and np.array_equal(
                got, want.astype(got.dtype)), path
    check(tree, state)


def test_expert_shards_must_split_evenly():
    """E % P != 0 raises a ValueError that names E and P: in the block,
    the specs, the train step and the dry run's specs."""
    cfg = get_reduced("phi3_5_moe_42b")                  # E = 4

    class Three:
        size, rank = 3, 0
    with pytest.raises(ValueError, match="E=4 .* P=3"):
        api.param_specs(cfg, expert_shard=(0, 3))
    with pytest.raises(ValueError, match="E=4 .* P=3"):
        train_state_specs(cfg, (1, 3))
    with pytest.raises(ValueError, match="E=4 .* P=3"):
        make_train_step(cfg, AdamWConfig(), comm=Three())
    p = {k: torch.zeros(s.shape) for k, s in TMOE.moe_specs(cfg).items()}
    with pytest.raises(ValueError, match="E=4 .* P=3"):
        TMOE.moe_block(p, torch.zeros((3, 2, cfg.d_model)), cfg, Three())
    # a rank's shard without its world
    shard = {k: torch.zeros(s.shape) for k, s in
             TMOE.moe_specs(cfg, 2).items()}
    with pytest.raises(ValueError, match="pass the rank's comm"):
        TMOE.moe_block(shard, torch.zeros((2, 2, cfg.d_model)), cfg)


def test_replicated_tokens_refuse_a_gradient():
    """Replicated tokens are for serving: no gradient flows back through
    the all-gather of the experts' outputs, so a block whose experts need
    one raises before any collective."""
    cfg = get_reduced("phi3_5_moe_42b")                  # E = 4

    class Two:
        size, rank = 2, 1
    shard = {k: torch.zeros(s.shape).requires_grad_() for k, s in
             TMOE.moe_specs(cfg, 2).items()}
    x = torch.zeros((2, 2, cfg.d_model))
    with pytest.raises(RuntimeError, match="for serving"):
        TMOE.moe_block(shard, x, cfg, Two(), replicated=True)


def test_comm_counts_the_new_kinds_and_the_tap_agrees(world):
    """Each all-to-all and all-gather counts its calls, the words and
    bytes this rank sends and its host seconds, as the kinds
    ``"all_to_all"`` / ``"all_gather"``; a ``WireTap`` open around the
    block records the same calls and words."""
    _, tc, _, pt, x = _setup(1.25)
    got = EP.ep_block(world.ranks(4), tc, pt, torch.from_numpy(x), 4)
    B, S, D = x.shape
    for r, (cs, wire) in enumerate(zip(got["counters"], got["wire"])):
        c = cs[-1]
        summ = collective_summary(c)
        assert summ.by_kind == collective_summary(wire).by_kind
        assert summ.calls("all_to_all") == 2 and \
            summ.calls("all_gather") == 1
        # the counts gathered: (groups, E) int64 words
        assert c["gather_words"] == EXPERTS and \
            c["gather_bytes"] == 8 * EXPERTS
        assert c["a2a_bytes"] == 4 * c["a2a_words"] and c["a2a_s"] > 0
        assert c["bytes"] == c["a2a_bytes"] + c["gather_bytes"] + 4 * EXPERTS
    # the first all-to-all sends each kept slot's token once, the second
    # returns it: 2 x kept slots x D words over the world
    kept = round((1 - float(got["metrics"]["moe_drop_frac"])) * B * S * 2)
    assert sum(cs[-1]["a2a_words"] for cs in got["counters"]) == \
        2 * kept * D


def test_contract_pass_refuses_the_new_kinds_on_a_solver_path():
    """No solver declares an all-to-all or an all-gather: the contract
    pass's record check names each as a disallowed kind."""
    rec = {"all_reduces": 1, "words": 4, "hops": 0, "hop_words": 0,
           "all_to_alls": 2, "a2a_words": 10, "all_gathers": 1,
           "gather_words": 3}
    summ = collective_summary(rec)
    assert summ.by_kind == {"all_reduce": (1, 4), "all_to_all": (2, 10),
                            "all_gather": (1, 3)}
    violations = []
    _check_record(summ, ("all_reduce",), 1, "primal s=1", violations)
    assert sorted(v.message.split()[1] for v in violations) == \
        ["all_gather", "all_to_all"]
    assert all(v.check == "collective-kind" for v in violations)
