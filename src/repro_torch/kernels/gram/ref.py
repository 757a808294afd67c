"""Plain PyTorch versions of the sampled Gram kernels: the port's oracles.

Each function is the counterpart of the jnp oracle of the same name in the
reference package and is what a kernel wrapper computes on a CPU tensor.
Accumulation follows the reference rule: float32 for float32 (and bf16)
input, float64 for float64 input.  The sampled panel is materialised here --
these are the plain versions, not the hot path.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def gram_ref(A: torch.Tensor, scale: float = 1.0, reg: float = 0.0
             ) -> torch.Tensor:
    """G = scale * A @ A^T + reg * I."""
    acc = acc_dtype(A.dtype)
    A = A.to(acc)
    G = A @ A.T
    return scale * G + reg * torch.eye(A.shape[0], dtype=acc, device=A.device)


def gram_packet_ref(A: torch.Tensor, u: torch.Tensor, scale: float = 1.0,
                    reg: float = 0.0, scale_r: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, r) = (scale * A A^T + reg * I, scale_r * A u); ``scale_r``
    defaults to ``scale``."""
    acc = acc_dtype(A.dtype)
    sr = scale if scale_r is None else scale_r
    G = gram_ref(A, scale, reg)
    r = sr * (A.to(acc) @ u.to(acc))
    return G, r


def gram_packet_sampled_ref(X: torch.Tensor, flat: torch.Tensor,
                            u: torch.Tensor, scale: float = 1.0,
                            reg: float = 0.0, scale_r: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-sampled packet: ``gram_packet_ref(X[flat, :], u)``."""
    return gram_packet_ref(X[flat.long(), :], u, scale, reg, scale_r)


def gram_packet_sampled_cols_ref(X: torch.Tensor, flat: torch.Tensor,
                                 u: torch.Tensor, scale: float = 1.0,
                                 reg: float = 0.0,
                                 scale_r: float | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-sampled packet: ``gram_packet_ref(X[:, flat].T, u)`` -- the
    dual's (G, r) = (scale * Y^T Y + reg * I, scale_r * Y^T u) for
    Y = X[:, flat]."""
    return gram_packet_ref(X[:, flat.long()].T, u, scale, reg, scale_r)


def panel_apply_ref(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """out(n) = scale * X[flat, :]^T v (the primal's ``alpha += Y^T dw``)."""
    acc = acc_dtype(X.dtype)
    return scale * (X[flat.long(), :].to(acc).T @ v.to(acc))


def panel_apply_cols_ref(X: torch.Tensor, flat: torch.Tensor,
                         v: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """out(d) = scale * X[:, flat] @ v (the dual's ``w -= Y da / (lam n)``)."""
    acc = acc_dtype(X.dtype)
    return scale * (X[:, flat.long()].to(acc) @ v.to(acc))


def _per_tenant(Y: torch.Tensor, t: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """``scale * (Y @ t)`` in the accumulation dtype, for t (K,) or, one
    product per tenant, for t (T, K).  A (T, K) matrix product would round
    differently from the single product a packet's r is; each tenant's row
    is copied first so that it is laid out as a single solve's vector."""
    acc = acc_dtype(Y.dtype)
    if t.dim() == 1:
        return scale * (Y.to(acc) @ t.to(acc))
    return torch.stack([scale * (Y.to(acc) @ ti.clone().to(acc))
                        for ti in t])


def panel_matvec_ref(X: torch.Tensor, flat: torch.Tensor, t: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """out(m) = scale * X[flat, :] t, the residual direction, for t (n,);
    (T, m) for T tenant vectors t (T, n).  The exact expression of
    :func:`gram_packet_sampled_ref`'s r, so the two agree bit for bit."""
    return _per_tenant(X[flat.long(), :], t, scale)


def panel_matvec_cols_ref(X: torch.Tensor, flat: torch.Tensor,
                          t: torch.Tensor, scale: float = 1.0
                          ) -> torch.Tensor:
    """out(m) = scale * X[:, flat]^T t, the dual residual direction, for
    t (d,); (T, m) for t (T, d).  The exact expression of
    :func:`gram_packet_sampled_cols_ref`'s r."""
    return _per_tenant(X[:, flat.long()].T, t, scale)
