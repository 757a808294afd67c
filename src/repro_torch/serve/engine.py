"""Batched LM serving engine: slot-based continuous batching, the twin of
``repro.serve.engine``.

* A fixed decode batch of ``slots``; each slot owns a stripe of every cache
  leaf (slot axis = axis 1; axis 0 is the layer stack).
* Queued prompts are admitted into free slots by a prefill: for attention
  families bucketed to a power of two with right padding (safe: decode
  masks keys past ``pos``); for the ssm / hybrid families unpadded, since
  a recurrence is not mask-protected, so prompts align to the SSD chunk.
  The prefill's cache stripe is copied into the slot.
* The first generated token.  Attention families: ``pos`` is set to the
  last prompt position and the last prompt token is replayed through
  decode, so the first token comes from clean logits at that position
  rather than from the padded prefill's (the replay rewrites that cache
  row with the same k / v).  ssm / hybrid: the unpadded prefill's last
  logits are exact, so the first token comes from them and decode starts
  at ``pos = plen``.  A replay there would feed the last prompt token to
  the conv and ssm states a second time; the reference's engine does that
  and so departs from its own stepwise greedy oracle (its test's constant
  prompt hides it for mamba2; ROADMAP.md, queue 3).
* Every :meth:`Engine.step` decodes all slots in one call (inactive slots
  compute values that are never read; a slot whose first token came from
  its prefill in this step keeps its recurrent state, which the call would
  advance, by a copy taken before it).
* Greedy (argmax over the unpadded vocabulary) or temperature sampling,
  with EOS and length retirement.  Sampling draws from a
  ``torch.Generator`` seeded by ``ServeConfig.seed``: its stream is not the
  reference's ``jax.random`` stream, by design.
* The audio family (encoder-decoder) is refused: a request here is a
  token prompt, and its prefill also needs the encoder's frames, as in the
  reference's engine, which hands ``prefill`` the tokens alone.  It is
  served through ``api.prefill`` / ``api.decode_step``.

The model runs on its own device; nothing here moves it.

``Engine(..., comm=...)`` serves an MoE model whose experts are sharded
over a world of ranks (``models.moe``; the model holds the rank's E / P
experts, ``api.param_specs(cfg, expert_shard=(rank, P))``): every rank
runs an engine on the same requests (replicated), and each prefill and
decode call dispatches over the world (``replicated=True``: one
all-gather of the experts' outputs an MoE layer), so every rank computes
the same logits and samples the same tokens as the one-rank engine.
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


RECURRENT = ("ssm", "hybrid")          # families with mamba state


class Engine:
    def __init__(self, model_cfg, model, cfg: ServeConfig, comm=None):
        if model_cfg.family == "audio":
            raise ValueError(
                f"{model_cfg.name}: the engine serves decoders; an "
                f"encoder-decoder's prefill also needs the encoder's frames "
                f"(src_embeds), which a token request does not carry (the "
                f"reference's engine hands prefill the tokens alone) -- use "
                f"api.prefill and api.decode_step")
        self.mc = model_cfg
        self.cfg = cfg
        self.model = model
        self.comm = comm
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
        if self.mc.family in RECURRENT:
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
        Returns {rid: new_token} for slots that produced a token (a slot
        admitted in this step of the ssm / hybrid families: its prefill's
        token)."""
        fresh = self._admit()
        if not self.active.any():
            return {}
        out = {}
        waiting = [s for s in self.table.active_slots() if s not in fresh]
        if waiting:
            tok = np.zeros((self.cfg.slots,), np.int32)
            for s in waiting:
                req = self.table.request_in(s)
                tok[s] = (req.out[-1] if req.out else req.payload[-1])
            kept = self._state_of(fresh)
            sampled = self._decode(tok, self.pos).cpu().numpy()
            self._restore(kept)
            for s in waiting:
                out[s] = int(sampled[s])
                self.pos[s] += 1
        out.update(fresh)
        produced = {}
        for s, t in sorted(out.items()):
            req = self.table.request_in(s)
            req.out.append(t)
            produced[req.rid] = t
            if ((self.cfg.eos_id is not None and t == self.cfg.eos_id)
                    or self.pos[s] >= self.cfg.max_seq):
                self._retire(s)
        return produced

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
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Tokens from logits (rows, Vpad): argmax over the unpadded
        vocabulary, or a draw at the temperature."""
        logits = logits[:, :self.mc.vocab]           # mask vocab padding
        if self.cfg.temperature > 0:
            probs = torch.softmax(logits.float() / self.cfg.temperature,
                                  dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _decode(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode call for every slot; the sampled tokens (slots,)."""
        logits, self.cache = api.decode_step(
            self.model, self.mc, self.cache,
            torch.from_numpy(tok).to(self.device),
            torch.from_numpy(pos).to(self.device), expert_comm=self.comm)
        return self._sample(logits)

    def _prefill(self, tokens: np.ndarray):
        return api.prefill(self.model, self.mc,
                           {"tokens": torch.from_numpy(tokens).to(
                               self.device)}, max_seq=self.cfg.max_seq,
                           comm=self.comm, replicated=True)

    def _state_of(self, slots) -> list:
        """Copies of the recurrent leaves' stripes of ``slots`` (the mamba
        state; attention rows past ``pos`` are rewritten before they are
        read)."""
        return [(leaf, s, leaf[:, s].clone())
                for sub in self.cache.get("blocks", {}).values()
                for name, leaf in sub.items() if name not in ("k", "v")
                for s in slots]

    @staticmethod
    def _restore(kept: list) -> None:
        for leaf, s, saved in kept:
            leaf[:, s] = saved

    def _admit(self) -> dict[int, int]:
        """Prefill each admitted request into its slot.  Returns {slot:
        first token} for the ssm / hybrid slots, whose first token comes
        from the prefill."""
        fresh = {}
        for req in self.table.admit():
            s = req.slot
            plen = len(req.payload)
            recurrent = self.mc.family in RECURRENT
            bucket = plen if recurrent else bucket_pow2(
                plen, self.cfg.min_bucket, self.cfg.max_seq)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :plen] = req.payload[:bucket]
            logits, cache1 = self._prefill(toks)
            # copy the single-request cache stripe into slot s (axis 1:
            # axis 0 is the layer stack)
            for sub, one in cache1["blocks"].items():
                for name, leaf in one.items():
                    self.cache["blocks"][sub][name][:, s] = leaf[:, 0]
            req.out = []
            if recurrent:
                # exact logits at the last prompt position: the first token,
                # and decode starts at plen
                fresh[s] = int(self._sample(logits)[0])
                self.pos[s] = plen
            else:
                # decode replays the last prompt token at plen - 1 (which
                # also rewrites that cache row), not the padded prefill's
                # logits
                self.pos[s] = plen - 1
        return fresh

    def _retire(self, slot: int) -> None:
        self.table.retire(slot)
        self.pos[slot] = 0
