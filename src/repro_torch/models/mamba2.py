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

On a grid of ranks (:func:`grid_block_with_state`, :func:`grid_decode_step`)
the block runs with its ``"inner"`` leaves cut over the 'model' group, as
the reference's rule table cuts them: ``wz`` / ``wx`` / ``conv_x`` / ``norm``
by the rank's channels of d_inner, ``out`` by its rows, and ``wdt`` /
``A_log`` / ``D`` / ``dt_bias`` by its heads where the heads divide the
group (``heads_cut``).  ``wB`` / ``wC`` / ``conv_B`` / ``conv_C`` are
whole: B and C are computed before the tensor-parallel region and enter
it by ``copy_to``, so that every rank's gradient of those leaves is the
whole one.  The gated norm runs over the whole d_inner: the rank's sum of
squares, one all-reduce over 'model' both ways (``copy_to(reduce_from(.))``,
since each rank's gradient of the sum is a partial one), one all-reduce
after ``out``.  Where the heads do not divide the group (``heads_cut``
false: a rank may hold part of a head), dt, A and D are computed whole
before the region and enter it by ``copy_to``, the rank's conv'd channels
are all-gathered over 'model' so that every rank scans every head (the
whole ``ssm`` state, which the cache then holds whole on every rank), and
each rank keeps its channels of the scan's output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import copy_to, gather_from, reduce_from
from .layers import acc_dtype, rmsnorm
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


# ------------------------------------------------------------ on a grid ----

def _grid_norm(y: torch.Tensor, w: torch.Tensor, cfg, m) -> torch.Tensor:
    """:func:`~repro_torch.models.layers.rmsnorm` over the whole d_inner of
    the rank's channels ``y``: the rank's sum of squares in
    ``layers.acc_dtype``, summed over 'model' both ways (forward and the
    gradient), over the whole d_inner."""
    di = cfg.ssm.d_inner(cfg.d_model)
    acc = acc_dtype(y.dtype)
    ya = y.to(acc)
    ss = copy_to(reduce_from((ya * ya).sum(dim=-1, keepdim=True), m), m)
    return (ya * torch.rsqrt(ss / di + cfg.norm_eps) * w.to(acc)).to(y.dtype)


def _grid_heads(p, x, m, heads_cut: bool):
    """dt (f32, softplus'd and biased), A and D of the heads a rank scans:
    its own, from ``x`` inside the region, where the heads are cut; else
    every head, computed from ``x`` before the region and entering it by
    ``copy_to`` (their gradients summed over 'model')."""
    dt = F.softplus((x @ p["wdt"]).to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if heads_cut:
        return dt, A, p["D"]
    return copy_to(dt, m), copy_to(A, m), copy_to(p["D"], m)


def grid_block_with_state(p, x: torch.Tensor, cfg, m, rank: int,
                          heads_cut: bool) -> tuple[torch.Tensor, dict]:
    """:func:`mamba_block_with_state` of a rank on a grid (module
    docstring): ``p`` its blocks of the block's leaves, x (B, L, D) whole
    on the 'model' group ``m`` (the rank at ``rank`` of it).  Returns the
    block's output (B, L, D), the sum over 'model', and the rank's block
    of the decode state: its heads of ``ssm`` (every head where
    ``heads_cut`` is false), its channels of ``conv_x``, the whole
    ``conv_B`` / ``conv_C``."""
    s = cfg.ssm
    Bsz, L, _ = x.shape
    W = s.d_conv
    Bm0 = x @ p["wB"]
    Cm0 = x @ p["wC"]
    Bm = F.silu(_causal_conv(Bm0, p["conv_B"])).to(F32)
    Cm = F.silu(_causal_conv(Cm0, p["conv_C"])).to(F32)
    Bm, Cm = copy_to(torch.cat([Bm, Cm], dim=-1), m).split(
        [Bm.shape[-1], Cm.shape[-1]], dim=-1)    # whole: one copy_to
    if not heads_cut:
        dt, A, D = _grid_heads(p, x, m, False)
    x = copy_to(x, m)
    if heads_cut:
        dt, A, D = _grid_heads(p, x, m, True)
    z = x @ p["wz"]
    xin0 = x @ p["wx"]
    xin = F.silu(_causal_conv(xin0, p["conv_x"]))
    width = xin.shape[-1]
    scanned = xin if heads_cut else gather_from(xin, m, xin.dim() - 1)
    xh = scanned.reshape(Bsz, L, -1, s.head_dim).to(F32)
    y, S = ssd_chunked(xh * dt[..., None], dt * A, Bm, Cm, s.chunk)
    y = (y + xh * D[..., :, None]).reshape(Bsz, L, -1)
    if not heads_cut:                           # the rank's channels
        y = y[..., rank * width:(rank + 1) * width]
    y = _grid_norm(y.to(x.dtype) * F.silu(z), p["norm"], cfg, m)
    state = {"ssm": S, "conv_x": xin0[:, -(W - 1):, :],
             "conv_B": Bm0[:, -(W - 1):, :], "conv_C": Cm0[:, -(W - 1):, :]}
    return reduce_from(y @ p["out"], m), state


def grid_decode_step(p, state: dict, xt: torch.Tensor, cfg, m, rank: int,
                     heads_cut: bool):
    """:func:`mamba_decode_step` of a rank on a grid: ``state`` the rank's
    block of the layer's decode state (:func:`grid_block_with_state`'s),
    xt (B, D) whole on the 'model' group.  One all-reduce for the norm and
    one after ``out`` (and, where the heads are not cut, one all-gather of
    the rank's conv'd channels).  Returns ((B, D), the new state block)."""
    s = cfg.ssm
    Bsz = xt.shape[0]
    conv_B, Bm = _conv_step(state["conv_B"], xt @ p["wB"], p["conv_B"])
    conv_C, Cm = _conv_step(state["conv_C"], xt @ p["wC"], p["conv_C"])
    dt, A, D = _grid_heads(p, xt, m, heads_cut)
    z = xt @ p["wz"]
    conv_x, xin = _conv_step(state["conv_x"], xt @ p["wx"], p["conv_x"])
    xin, Bm, Cm = F.silu(xin), F.silu(Bm), F.silu(Cm)
    width = xin.shape[-1]
    scanned = xin if heads_cut else gather_from(xin, m, 1)
    xh = scanned.reshape(Bsz, -1, s.head_dim).to(F32)
    S = state["ssm"] * torch.exp(dt * A)[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh * dt[..., None], Bm.to(F32))
    y = torch.einsum("bhpn,bn->bhp", S, Cm.to(F32))
    y = (y + xh * D[..., :, None]).reshape(Bsz, -1)
    if not heads_cut:                           # the rank's channels
        y = y[:, rank * width:(rank + 1) * width]
    y = _grid_norm(y.to(xt.dtype) * F.silu(z), p["norm"], cfg, m)
    return reduce_from(y @ p["out"], m), {
        "ssm": S, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
