"""The paper's technique on the LM's features: fit a linear probe (ridge
readout) on frozen LM hidden states with CA-BDCD; the twin of
``examples/lm_probe.py``.

The design matrix is the LM's last hidden state before the head,
X in R^{d_model x n_tokens} (f64), the targets are +-1 labels of the next
token (top half of the vocabulary or not), and the dual solver fits the
probe while synchronising only every s iterations.  On the card the dual's
column-sampled packet and update run through the kernels K3 and K4 on X in
its (d_model, tokens) layout.

Run:  PYTHONPATH=src python -m repro_torch.launch.lm_probe [--seed N]
      [--full] [--device cuda|cpu]
``--full`` probes the published llama3.2-3b width (random weights, f32:
12.85 GB of parameters) instead of the reduced configuration.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import bdcd, ca_bdcd, ridge_exact, sample_blocks
from repro_torch.data import synthetic_lm_batch
from repro_torch.data.regression import check_device
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.models.api import _decoder_stack, _embed, _positions

ITERS, B, S = 200, 32, 10


def extract_features(cfg, model, batch) -> torch.Tensor:
    """Last-hidden-state features before the LM head: (d_model, tokens) in
    f64, contiguous, on the model's device."""
    x = _embed(model, cfg, batch)
    h, _ = _decoder_stack(model, cfg, x, _positions(x.shape[1], x.device))
    h = L.rmsnorm(h, model.top["final_norm"], cfg.norm_eps)
    d = h.shape[-1]
    return h.reshape(-1, d).T.to(torch.float64).contiguous()


def probe_config(full: bool = False):
    """llama3.2-3b (published or reduced) with f32 weights and activations,
    as the reference's probe."""
    cfg = get_config("llama3_2_3b") if full else get_reduced("llama3_2_3b")
    return dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32)


def design(cfg, model, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's design matrix (:func:`extract_features`) and its +-1
    targets (the next token in the top half of the vocabulary or not)."""
    X = extract_features(cfg, model, batch)
    y = torch.as_tensor(
        2.0 * (np.asarray(batch["labels"]).reshape(-1) > cfg.vocab // 2)
        - 1.0, dtype=torch.float64, device=X.device)
    return X, y


def fit(X, y, generator: torch.Generator, *, iters: int = ITERS, b: int = B,
        s: int = S) -> dict:
    """Exact ridge, then BDCD and CA-BDCD(s) on one shared index stream
    drawn from ``generator``.  Returns the design matrix's shape, lambda,
    the largest |w_ca - w_bdcd|, the solution error against the exact
    ridge, the train accuracy and both results."""
    d, n = X.shape
    lam = 1e-4 * float(torch.linalg.norm(X) ** 2 / n)
    w_opt = ridge_exact(X, y, lam)
    idx = sample_blocks(generator, n, b, iters)
    res_cl = bdcd(X, y, lam, b, iters, idx=idx, w_ref=w_opt)
    res_ca = ca_bdcd(X, y, lam, b, s, iters, idx=idx, w_ref=w_opt)
    return {"d": d, "n": n, "lam": lam,
            "dev": float((res_ca.w - res_cl.w).abs().max()),
            "err": float(res_ca.history["sol_err"][-1]),
            "acc": float((torch.sign(X.T @ res_ca.w) == y).double().mean()),
            "iters": iters, "s": s, "classical": res_cl, "ca": res_ca}


def probe(cfg, model, batch, generator: torch.Generator, **knobs) -> dict:
    """:func:`design` then :func:`fit`."""
    return fit(*design(cfg, model, batch), generator, **knobs)


def report(out: dict) -> None:
    print(f"probe design matrix: {out['d']} features x {out['n']} tokens, "
          f"lambda={out['lam']:.2e}")
    print(f"CA-BDCD == BDCD on LM features: max |w diff| = {out['dev']:.2e}")
    print(f"probe solution error vs exact ridge: {out['err']:.2e}")
    print(f"probe train accuracy: {out['acc']:.3f}")
    print(f"synchronizations: {out['iters']} (classical) vs "
          f"{out['iters'] // out['s']} (CA, s={out['s']})")


def main(seed: int = 0, *, full: bool = False, device="cuda") -> dict:
    device = check_device(device)
    cfg = probe_config(full)
    model = DecoderLM.init(
        cfg, torch.Generator(device=device).manual_seed(seed))
    batch = synthetic_lm_batch(cfg.vocab, seq_len=128, batch=8,
                               seed=seed + 3)
    out = probe(cfg, model, batch,
                torch.Generator(device=device).manual_seed(seed + 4))
    report(out)
    if not out["dev"] < 1e-8:
        raise AssertionError(f"CA-BDCD must match BDCD: {out['dev']:.2e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the batch and the index "
                         "stream (fixed default => reproducible output)")
    ap.add_argument("--full", action="store_true",
                    help="llama3.2-3b at its published width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args()
    main(args.seed, full=args.full, device=args.device)
