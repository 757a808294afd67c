"""Synthetic regularized-least-squares problems with controlled spectra.

The paper's LIBSVM datasets (Table 3) are replaced by generators matched in
shape and conditioning: X = U diag(sigma) V^T with orthogonal factors (QR of
Gaussians) and a log-linear singular value ramp, plus optional sparsity to
mimic nnz%.  The labels are y = X^T w_star + noise.  X is stored dense, as
the reference stores it.

``PAPER_DATASETS`` holds the reference's stand-ins (8x cuts of the larger
shapes); ``PAPER_DATASETS_FULL`` the full Table 3 shapes with the same
conditioning and density.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    d: int                 # features (rows of X)
    n: int                 # data points (columns of X)
    cond: float            # sigma_max / sigma_min of X^T X
    noise: float = 1e-2
    density: float = 1.0   # fraction of entries kept (0 < density <= 1)


PAPER_DATASETS = {
    "abalone": SyntheticSpec("abalone", d=8, n=4177, cond=5.3e8),
    "news20": SyntheticSpec("news20", d=7757, n=1991, cond=3.5e11,
                            density=0.0013),
    "a9a": SyntheticSpec("a9a", d=123, n=4069, cond=4.1e10, density=0.11),
    "real-sim": SyntheticSpec("real-sim", d=2619, n=9038, cond=8.4e5,
                              density=0.0024),
}

PAPER_DATASETS_FULL = {
    "abalone": PAPER_DATASETS["abalone"],
    "news20": dataclasses.replace(PAPER_DATASETS["news20"], d=62061,
                                  n=15935),
    "a9a": dataclasses.replace(PAPER_DATASETS["a9a"], n=32561),
    "real-sim": dataclasses.replace(PAPER_DATASETS["real-sim"], d=20958,
                                    n=72309),
}


def check_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device on a machine without CUDA raises
    (the entry points never drop to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def make_regression(generator: torch.Generator, spec: SyntheticSpec,
                    dtype: torch.dtype = torch.float64, *, device="cuda"):
    """Returns (X (d, n), y (n,), w_star (d,)) on ``device``, drawn from
    ``generator`` (which must live on that device).

    The singular values of X are spaced geometrically so that
    cond(X^T X) = spec.cond.  The sparsity mask is applied in place, to keep
    the peak memory of a full-size problem near three copies of X.
    """
    device = check_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, device {device}")
    d, n = spec.d, spec.n
    r = min(d, n)
    opts = {"dtype": dtype, "device": device, "generator": generator}
    U, _ = torch.linalg.qr(torch.randn((d, r), **opts))
    V, _ = torch.linalg.qr(torch.randn((n, r), **opts))
    # sqrt(cond) ramp on X's singular values => cond on the Gram spectrum.
    ramp = torch.logspace(0.0, -0.5 * math.log10(spec.cond), r, dtype=dtype,
                          device=device)
    X = (U * ramp) @ V.T
    del U, V
    if spec.density < 1.0:
        keep = torch.rand((d, n), **opts) < spec.density
        X.div_(spec.density).masked_fill_(~keep, 0.0)
        del keep
    w_star = torch.randn((d,), **opts)
    y = X.T @ w_star
    y = y + spec.noise * torch.linalg.norm(y) / math.sqrt(n) * torch.randn(
        (n,), **opts)
    return X, y, w_star


def lam_for(X: torch.Tensor, scale: float = 1000.0) -> torch.Tensor:
    """The paper's regularizer choice: lambda = 1000 * sigma_min(X^T X)."""
    d, n = X.shape
    G = X @ X.T if d <= n else X.T @ X
    evs = torch.linalg.eigvalsh(G)
    return scale * torch.clamp(evs[0], min=1e-30)
