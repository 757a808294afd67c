"""Deterministic, resumable, host-shardable synthetic LM token pipeline: the
port's own copy of ``repro.data.tokens`` (numpy only), giving the same
arrays for the same seed.

Design goals of a production input pipeline that matter even with synthetic
data (and are all tested):

* **Determinism / exact resume** -- batches are a pure function of
  (seed, step) via the counter-based Philox generator, so checkpointing the
  integer ``step`` is sufficient to resume the exact stream.  No iterator
  state can drift across restarts or host failures.
* **Host sharding** -- each host materializes only its ``1/num_hosts`` slice
  of the global batch (disjoint Philox streams per host), the standard
  multi-pod input layout.
* **Learnability** -- tokens follow a noisy affine next-token process
  ``t_{k+1} = (a * t_k + c) mod V`` so end-to-end training loss demonstrably
  falls; pure-uniform streams cannot show that.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    noise: float = 0.05           # fraction of positions replaced with uniform noise
    step: int = 0                 # resumable cursor

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = self.global_batch // self.num_hosts
        # affine map parameters; co-prime-ish with vocab for long cycles
        self._a = 6364136223846793005 % max(self.vocab - 3, 2) | 1
        self._c = 1442695040888963407 % max(self.vocab - 3, 2)

    def _rng(self, step: int) -> np.random.Generator:
        # 128-bit Philox key: (seed | host) and step -- a pure counter scheme.
        return np.random.Generator(np.random.Philox(
            key=[(self.seed << 20) ^ self.host_index, step]))

    def batch_at(self, step: int) -> dict:
        """Pure function of step -> {tokens (B_local, S+1) int32}."""
        rng = self._rng(step)
        v = self.vocab
        b, s = self.local_batch, self.seq_len + 1
        t0 = rng.integers(0, v, size=(b, 1), dtype=np.int64)
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, 0] = t0[:, 0]
        for k in range(1, s):
            toks[:, k] = (toks[:, k - 1] * self._a + self._c) % v
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s), dtype=np.int64)
        toks = np.where(noise_mask, noise_tok, toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, self.seq_len), np.float32),
        }

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    # -- checkpoint integration -------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed,
                "host_index": self.host_index, "num_hosts": self.num_hosts}

    def load_state_dict(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError("resuming a stream with a different seed")
        self.step = int(state["step"])


def synthetic_lm_batch(vocab: int, seq_len: int, batch: int, seed: int = 0) -> dict:
    """One-shot batch helper for tests and smoke runs."""
    return TokenStream(vocab, seq_len, batch, seed=seed).batch_at(0)
