"""Batched LM serving engine: slot-based continuous batching, the twin of
``repro.serve.engine``.

* A fixed decode batch of ``slots``; each slot owns a stripe of every cache
  leaf (slot axis = axis 1; axis 0 is the layer stack).
* Queued prompts are admitted into free slots by a prefill bucketed to a
  power of two with right padding (safe: decode masks keys past ``pos``).
  The prefill's cache stripe is copied into the slot, ``pos`` is set to the
  last prompt position, and the last prompt token is replayed through
  decode, so the first generated token comes from clean logits at that
  position rather than from the padded prefill's.
* Every :meth:`Engine.step` decodes all slots in one call (inactive slots
  compute values that are never read).
* Greedy (argmax over the unpadded vocabulary) or temperature sampling,
  with EOS and length retirement.  Sampling draws from a
  ``torch.Generator`` seeded by ``ServeConfig.seed``: its stream is not the
  reference's ``jax.random`` stream, by design.

The model runs on its own device; nothing here moves it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.serve.slots import SlotTable, bucket_pow2


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    slots: int = 4
    temperature: float = 0.0
    eos_id: int | None = None
    seed: int = 0
    min_bucket: int = 32


class Engine:
    def __init__(self, model_cfg, model, cfg: ServeConfig):
        api.check_ported(model_cfg, "Engine")
        self.mc = model_cfg
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.cache = api.init_cache(model_cfg, cfg.slots, cfg.max_seq,
                                    self.device)
        self.pos = np.zeros((cfg.slots,), np.int32)       # next write position
        self.table = SlotTable(cfg.slots)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    # The slot bookkeeping lives in the shared table; these views keep the
    # reference engine's surface.
    @property
    def active(self):
        return self.table.active

    @property
    def slot_req(self):
        return self.table.slot_req

    @property
    def queue(self):
        return self.table.queue

    @property
    def requests(self):
        return self.table.requests

    # ------------------------------------------------------------ public --
    def add_request(self, prompt_tokens) -> int:
        prompt_tokens = list(map(int, prompt_tokens))
        if self.mc.family in ("ssm", "hybrid"):
            # SSM recurrences are not mask-protected: right padding would
            # pollute conv/ssm states, so prompts must align to the SSD
            # chunk (the chunked-prefill constraint).
            chunk = self.mc.ssm.chunk
            if len(prompt_tokens) % chunk:
                raise ValueError(
                    f"{self.mc.name}: prompt length {len(prompt_tokens)} must "
                    f"be a multiple of the SSD chunk ({chunk}) -- align or "
                    f"truncate the prompt (chunked-prefill constraint)")
        return self.table.submit(prompt_tokens)

    def step(self) -> dict[int, int]:
        """Admit queued requests, decode one token for all active slots.
        Returns {rid: new_token} for slots that produced a token."""
        self._admit()
        if not self.active.any():
            return {}
        tok = np.zeros((self.cfg.slots,), np.int32)
        for s in self.table.active_slots():
            req = self.table.request_in(s)
            tok[s] = (req.out[-1] if req.out else req.payload[-1])
        sampled = self._decode(tok, self.pos).cpu().numpy()
        out = {}
        for s in self.table.active_slots():
            t = int(sampled[s])
            req = self.table.request_in(s)
            req.out.append(t)
            out[req.rid] = t
            self.pos[s] += 1
            if ((self.cfg.eos_id is not None and t == self.cfg.eos_id)
                    or self.pos[s] >= self.cfg.max_seq):
                self._retire(s)
        return out

    def generate(self, prompts, max_new: int) -> list[list[int]]:
        rids = [self.add_request(p) for p in prompts]
        budget = {r: max_new for r in rids}
        while any(not self.requests[r].done and budget[r] > 0 for r in rids):
            produced = self.step()
            for r, _ in produced.items():
                if r in budget:
                    budget[r] -= 1
                    if budget[r] == 0 and not self.requests[r].done:
                        self._retire(self.requests[r].slot)
            if not produced and not self.queue:
                break
        return [self.requests[r].out for r in rids]

    # ----------------------------------------------------------- internal --
    def _decode(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode call for every slot; the sampled tokens (slots,)."""
        logits, self.cache = api.decode_step(
            self.model, self.mc, self.cache,
            torch.from_numpy(tok).to(self.device),
            torch.from_numpy(pos).to(self.device))
        logits = logits[:, :self.mc.vocab]           # mask vocab padding
        if self.cfg.temperature > 0:
            probs = torch.softmax(logits.float() / self.cfg.temperature,
                                  dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _prefill(self, tokens: np.ndarray):
        return api.prefill(self.model, self.mc,
                           {"tokens": torch.from_numpy(tokens).to(
                               self.device)}, max_seq=self.cfg.max_seq)

    def _admit(self) -> None:
        for req in self.table.admit():
            s = req.slot
            plen = len(req.payload)
            # ssm/hybrid: exact (chunk-aligned) prefill; attention: padded
            # power-of-two bucket (padding is attention-mask safe).
            bucket = plen if self.mc.family in ("ssm", "hybrid") \
                else bucket_pow2(plen, self.cfg.min_bucket, self.cfg.max_seq)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :plen] = req.payload[:bucket]
            _, cache1 = self._prefill(toks)
            # copy the single-request cache stripe into slot s (axis 1:
            # axis 0 is the layer stack)
            for sub, one in cache1["blocks"].items():
                for name, leaf in one.items():
                    self.cache["blocks"][sub][name][:, s] = leaf[:, 0]
            # the first generated token comes from decode replaying the last
            # prompt token at position plen - 1 (which also rewrites that
            # cache row), not from the padded prefill's logits
            self.pos[s] = plen - 1
            req.out = []

    def _retire(self, slot: int) -> None:
        self.table.retire(slot)
        self.pos[slot] = 0
