"""Mamba-2 (SSD, state-space duality) block, the twin of
``repro.models.mamba2``: the chunked scan, its token-by-token oracle, the
block's forward and its O(1) decode step.

The reference writes these in plain jnp, with no Pallas kernel, and so does
the port in plain torch: intra-chunk work is a masked (q x q) product,
inter-chunk work a sequential pass over chunk boundaries (the reference's
``lax.scan``, here a Python loop over chunks), so the O(L) part touches only
the (B, H, P, N) states.

Types follow the reference's casts exactly.  ``dt``, ``B``, ``C``, the
heads' inputs and every SSD product are float32, and so is the carried
state (the decode cache's ``ssm`` leaf), whatever the model's type: the
reference casts them to f32 and asks its einsums for f32 results.  So a
bf16 model runs its scan in f32, and an f64 model has f32 islands: the scan
and the state are f32 and the block's output goes back to f64 after them.
``A_log``, ``D`` and ``dt_bias`` are f32 parameters in every model
(:func:`mamba_specs`).

Decode is one state update per token, with no cache growth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm
from .module import ParamSpec

F32 = torch.float32


def mamba_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    pd = cfg.param_dtype
    return {
        "wz": ParamSpec((d, di), ("embed", "inner"), pd),
        "wx": ParamSpec((d, di), ("embed", "inner"), pd),
        "wB": ParamSpec((d, gn), ("embed", "state"), pd),
        "wC": ParamSpec((d, gn), ("embed", "state"), pd),
        "wdt": ParamSpec((d, h), ("embed", "inner"), pd),
        "conv_x": ParamSpec((s.d_conv, di), ("conv", "inner"), pd, scale=0.5),
        "conv_B": ParamSpec((s.d_conv, gn), ("conv", "state"), pd, scale=0.5),
        "conv_C": ParamSpec((s.d_conv, gn), ("conv", "state"), pd, scale=0.5),
        "A_log": ParamSpec((h,), ("inner",), F32, init="zeros"),
        "D": ParamSpec((h,), ("inner",), F32, init="ones"),
        "dt_bias": ParamSpec((h,), ("inner",), F32, init="zeros"),
        "norm": ParamSpec((di,), ("inner",), pd, init="ones"),
        "out": ParamSpec((di, d), ("inner", "embed"), pd),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; x (B, L, C), kernel (W, C).  The reference's
    sum of W shifted products, in its order."""
    W, L = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + L, :] * kernel[i][None, None, :] for i in range(W))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> (..., q, q) with ss[i, j] = sum_{k=j+1..i} a_k (i >= j),
    -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, ss, float("-inf"))


def ssd_chunked(xdt: torch.Tensor, dtA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, S0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  xdt (B, L, H, P) = x * dt; dtA (B, L, H) = dt * A
    (negative); Bm, Cm (B, L, N) (one group broadcast over heads); S0
    (B, H, P, N) or None.  Returns (y (B, L, H, P), final state
    (B, H, P, N)), both f32: the reference's products ask for f32 results
    and its carried state is f32, so any input is taken to f32.

    A ragged tail is zero-padded to whole chunks: dtA = 0 decays by
    exp(0) = 1 and xdt = 0 adds nothing, so the padding leaves the state as
    it is, and its outputs are dropped."""
    xdt, dtA, Bm, Cm = (t.to(F32) for t in (xdt, dtA, Bm, Cm))
    Bsz, L, H, Pdim = xdt.shape
    N = Bm.shape[-1]
    q = min(chunk, L)
    pad = (-L) % q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // q
    S = (torch.zeros((Bsz, H, Pdim, N), dtype=F32, device=xdt.device)
         if S0 is None else S0.to(F32))
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xc, ac, bc, cc = xdt[:, sl], dtA[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(ac, dim=1)                          # (B,q,H)
        Lmat = torch.exp(_segsum(ac.movedim(-1, 1)))           # (B,H,q,q)
        y_diag = torch.einsum("bqn,bkn,bhqk,bkhp->bqhp", cc, bc, Lmat, xc)
        decay_out = torch.exp(cum)                             # (B,q,H)
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", cc, S, decay_out)
        decay_states = torch.exp(cum[:, -1:, :] - cum)         # (B,q,H)
        S = S * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
            "bkn,bkh,bkhp->bhpn", bc, decay_states, xc)
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    return y[:, :L], S


def naive_ssd(xdt, dtA, Bm, Cm, S0=None):
    """Token-by-token recurrence oracle: S_t = S_{t-1} exp(dtA_t) +
    B_t (x dt)_t, y_t = S_t C_t, in the wider of f32 and the inputs' type
    (the tests' f64 oracle)."""
    acc = torch.promote_types(xdt.dtype, F32)
    xdt, dtA, Bm, Cm = (t.to(acc) for t in (xdt, dtA, Bm, Cm))
    Bsz, L, H, Pdim = xdt.shape
    N = Bm.shape[-1]
    S = (torch.zeros((Bsz, H, Pdim, N), dtype=acc, device=xdt.device)
         if S0 is None else S0.to(acc))
    ys = []
    for t in range(L):
        S = S * torch.exp(dtA[:, t])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xdt[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    return torch.stack(ys, dim=1), S


def _projections(p, x):
    """The block's input projections and its f32 dt (softplus'd, biased),
    A and the causal conv's inputs."""
    z = x @ p["wz"]
    xin0 = x @ p["wx"]
    Bm0 = x @ p["wB"]
    Cm0 = x @ p["wC"]
    dt = (x @ p["wdt"]).to(F32)
    dt = F.softplus(dt + p["dt_bias"])                       # (..., H)
    A = -torch.exp(p["A_log"])                               # (H,) negative
    return z, xin0, Bm0, Cm0, dt, A


def _output(p, y, xh, z, x_dtype, cfg):
    """Skip connection, gate, norm and out projection of the scan's y."""
    y = y + xh * p["D"][..., :, None]
    y = y.reshape(*y.shape[:-2], -1).to(x_dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"]


def mamba_block_with_state(p, x: torch.Tensor, cfg
                           ) -> tuple[torch.Tensor, dict]:
    """The block's forward on x (B, L, D) -> (B, L, D), and the decode state
    after its last token (the reference's ``api._mamba_block_with_state``):
    the scan's final state and the last W - 1 inputs of each conv."""
    s = cfg.ssm
    Bsz, L, _ = x.shape
    H = s.n_heads(cfg.d_model)
    z, xin0, Bm0, Cm0, dt, A = _projections(p, x)
    xin = F.silu(_causal_conv(xin0, p["conv_x"]))
    Bm = F.silu(_causal_conv(Bm0, p["conv_B"])).to(F32)
    Cm = F.silu(_causal_conv(Cm0, p["conv_C"])).to(F32)
    xh = xin.reshape(Bsz, L, H, s.head_dim).to(F32)
    y, S = ssd_chunked(xh * dt[..., None], dt * A, Bm, Cm, s.chunk)
    W = s.d_conv
    state = {"ssm": S, "conv_x": xin0[:, -(W - 1):, :],
             "conv_B": Bm0[:, -(W - 1):, :], "conv_C": Cm0[:, -(W - 1):, :]}
    return _output(p, y, xh, z, x.dtype, cfg), state


def mamba_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full Mamba-2 block forward; x (B, L, D) -> (B, L, D)."""
    return mamba_block_with_state(p, x, cfg)[0]


# ------------------------------------------------------------- decode ----

def mamba_state_init(cfg, batch: int, device=None) -> dict:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    W = s.d_conv
    return {
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=F32,
                           device=device),
        "conv_x": torch.zeros((batch, W - 1, di), dtype=cfg.dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, gn), dtype=cfg.dtype,
                              device=device),
        "conv_C": torch.zeros((batch, W - 1, gn), dtype=cfg.dtype,
                              device=device),
    }


def _conv_step(buf: torch.Tensor, xt: torch.Tensor, kernel: torch.Tensor):
    """One causal-conv step; buf (B, W-1, C) history, xt (B, C)."""
    window = torch.cat([buf, xt[:, None, :].to(buf.dtype)], dim=1)
    out = torch.einsum("bwc,wc->bc", window, kernel)
    return window[:, 1:, :], out


def mamba_decode_step(p, state: dict, xt: torch.Tensor, cfg):
    """One-token state update; xt (B, D) -> ((B, D), new state).  O(1) in
    the position.  Returns a new state; the caller decides where it lives."""
    s = cfg.ssm
    Bsz = xt.shape[0]
    H = s.n_heads(cfg.d_model)
    z, xin, Bm, Cm, dt, A = _projections(p, xt)
    conv_x, xin = _conv_step(state["conv_x"], xin, p["conv_x"])
    conv_B, Bm = _conv_step(state["conv_B"], Bm, p["conv_B"])
    conv_C, Cm = _conv_step(state["conv_C"], Cm, p["conv_C"])
    xin, Bm, Cm = F.silu(xin), F.silu(Bm), F.silu(Cm)
    xh = xin.reshape(Bsz, H, s.head_dim).to(F32)
    S = state["ssm"] * torch.exp(dt * A)[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh * dt[..., None], Bm.to(F32))
    y = torch.einsum("bhpn,bn->bhp", S, Cm.to(F32))
    out = _output(p, y, xh, z, xt.dtype, cfg)
    return out, {
        "ssm": S, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
