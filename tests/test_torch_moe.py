"""The port's mixture-of-experts block (``repro_torch.models.moe``) against
the reference's, on the CPU, in f32.

The block's weights are the reference's (its ``init_params`` on
``moe_specs``) and its input is made with numpy from a seed; both packages
get the same arrays.  Tolerances: the routing (top-k, capacity, drops) is
discrete and must agree exactly -- the same experts, the same kept slots
and the same drop fraction; outputs atol / rtol 1e-5 on values of order
0.1-1 (each side rounds its own f32 products over 32-64 inputs); the aux
loss rtol 1e-6 (an f32 sum of E products).  The no-drop output against
the dense weighted sum of every expert: the reference's 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import MoEConfig as JMoE
from repro.models import init_params as jinit
from repro.models import moe as JMOE
from repro_torch.configs import MoEConfig, get_reduced
from repro_torch.models import moe as TMOE

OUT_TOL = 1e-5


def _setup(capacity_factor=1.25, groups=1, experts=8, top_k=2, d=32, f=64,
           tokens=(2, 64), seed=0):
    moe = {"num_experts": experts, "top_k": top_k,
           "capacity_factor": capacity_factor, "groups": groups}
    jc = dataclasses.replace(j_reduced("phi3_5_moe_42b"), d_model=d, d_ff=f,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             moe=JMoE(**moe))
    tc = dataclasses.replace(get_reduced("phi3_5_moe_42b"), d_model=d,
                             d_ff=f, dtype=torch.float32,
                             param_dtype=torch.float32, moe=MoEConfig(**moe))
    pj = jinit(JMOE.moe_specs(jc), jax.random.key(seed))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = np.random.default_rng(seed).standard_normal((*tokens, d)) \
        .astype(np.float32)
    return jc, tc, pj, pt, x


def _run_both(capacity_factor, groups=1, **kw):
    jc, tc, pj, pt, x = _setup(capacity_factor, groups, **kw)
    out, m = TMOE.moe_block(pt, torch.from_numpy(x), tc)
    outj, mj = JMOE.moe_block(pj, jnp.asarray(x), jc)
    return (out, m), (outj, mj), (tc, pt, x)


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True),
                                                   (4.0, False)])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_block_matches_reference(capacity_factor, drops, groups):
    """Output, aux loss and drop fraction at capacity 1.25 (tokens dropped
    at one group) and 4.0 (none dropped), over 1, 2 and 4 dispatch groups;
    and the same bits on a second call."""
    (out, m), (outj, mj), (tc, pt, x) = _run_both(capacity_factor, groups)
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert m.keys() == mj.keys() == {"moe_aux_loss", "moe_drop_frac"}
    assert float(m["moe_drop_frac"]) == float(mj["moe_drop_frac"])
    np.testing.assert_allclose(float(m["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=1e-6)
    if groups == 1:
        assert (float(m["moe_drop_frac"]) > 0) == drops
    again, m2 = TMOE.moe_block(pt, torch.from_numpy(x), tc)
    assert torch.equal(out, again)
    assert all(torch.equal(m[k], m2[k]) for k in m)


def test_heavy_drops_match_reference():
    """Capacity 0.25 (the reference's drop test): most slots dropped, the
    residual carries them (their output rows are zero)."""
    (out, m), (outj, mj), _ = _run_both(0.25, experts=4, tokens=(2, 64))
    assert 0.0 < float(m["moe_drop_frac"]) == float(mj["moe_drop_frac"]) < 1
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), rtol=OUT_TOL,
                               atol=OUT_TOL)


def test_no_drop_equals_dense_oracle():
    """With no drops the sort-based dispatch is the dense weighted sum of
    every expert on every token (the reference's oracle)."""
    _, tc, _, pt, x = _setup(8.0)
    out, m = TMOE.moe_block(pt, torch.from_numpy(x), tc)
    assert float(m["moe_drop_frac"]) == 0.0
    xf = torch.from_numpy(x).reshape(-1, tc.d_model)
    probs = torch.softmax(xf @ pt["router"], -1)
    gate, sel = torch.topk(probs, tc.moe.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, pt["w1"]))
    g = torch.einsum("td,edf->tef", xf, pt["w3"])
    y_all = torch.einsum("tef,efd->ted", h * g, pt["w2"])
    oracle = sum(gate[:, k:k + 1] * y_all[torch.arange(len(xf)), sel[:, k]]
                 for k in range(tc.moe.top_k))
    np.testing.assert_allclose(out.reshape(len(xf), -1).numpy(),
                               oracle.numpy(), rtol=2e-4, atol=2e-4)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = TMOE._top_k(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_capacity_and_specs_match_reference():
    for args in ((1024, 2, 16, 1.25), (8, 1, 16, 1.0), (4, 2, 16, 1.25),
                 (512, 2, 16, 1.25), (77, 4, 16, 1.25)):
        assert TMOE._capacity(*args) == JMOE._capacity(*args)
    jc, tc, *_ = _setup()
    ts, js = TMOE.moe_specs(tc), JMOE.moe_specs(jc)
    assert ts.keys() == js.keys()
    for k in ts:
        assert ts[k].shape == js[k].shape and ts[k].axes == js[k].axes
    assert ts["router"].dtype == torch.float32       # f32 in every model
