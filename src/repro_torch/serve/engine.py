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

``Engine(..., grid=...)`` serves the dense decoder, the vlm (text-only
requests, as on one rank) and the ssm family (its prompts' rule and first
token as on one rank) on a grid of ranks in the reference's
production layout (``grid``: the rank's
``core.world.GridComm``; ``model``: the rank's model,
``models.api.grid_model``): each (pod, data) row of the grid serves its own
share of the requests (request i goes to row i mod R of the R rows) on
``slots / R`` slots, and the row's model ranks run the same engine in step
(tensor parallelism over 'model'; the cache cut as ``seq_shard`` says,
``models.api.cache_rules``).  Greedy tokens come from the vocab-cut logits
by one all-gather of each rank's (max, first index) over 'model'
(``GridLayout.greedy``); a temperature draw gathers the whole rows (one
all-gather) and draws with the row's generator, seeded ``seed + row``, so
every model rank of a row draws the same tokens.  The rows step
independently; :meth:`Engine.generate` ends with one all-reduce over
(pod, data) that gives every rank every request's tokens.  FSDP is
refused: its per-layer gathers over 'data' would need the rows in step.
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


def sample_tokens(logits: torch.Tensor, vocab: int, temperature: float,
                  generator: torch.Generator, layout=None) -> torch.Tensor:
    """Tokens from logits (rows, Vpad): argmax over the unpadded
    vocabulary, or a draw at ``temperature`` from ``generator``.  With
    ``layout`` (a rank's ``api.GridLayout``) whose vocab is cut over
    'model', ``logits`` are the rank's columns: greedy by
    ``GridLayout.greedy``, a draw from the rows gathered whole (module
    docstring)."""
    if layout is not None and layout.tp_vocab:
        if temperature <= 0:
            return layout.greedy(logits, vocab)
        logits = layout.whole_vocab(logits)
    logits = logits[:, :vocab]                   # mask vocab padding
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def check_served(model_cfg) -> None:
    """Raise for a family the engine does not serve: the encoder-decoder,
    whose prefill also needs the encoder's frames."""
    if model_cfg.family == "audio":
        raise ValueError(
            f"{model_cfg.name}: the engine serves decoders; an "
            f"encoder-decoder's prefill also needs the encoder's frames "
            f"(src_embeds), which a token request does not carry (the "
            f"reference's engine hands prefill the tokens alone) -- use "
            f"api.prefill and api.decode_step")


class Engine:
    def __init__(self, model_cfg, model, cfg: ServeConfig, comm=None,
                 grid=None, seq_shard: bool = True):
        check_served(model_cfg)
        self.mc = model_cfg
        self.cfg = cfg
        self.model = model
        self.comm = comm
        self.grid = grid
        self.seq_shard = seq_shard
        self.row, self.rows = 0, 1
        if grid is not None:
            self._check_grid(model_cfg, model, comm, grid)
            batch = grid.batch
            if batch is not None:
                self.row, self.rows = batch.rank, batch.size
            if cfg.slots % self.rows:
                raise ValueError(f"{cfg.slots} slots do not split over the "
                                 f"grid's {self.rows} rows")
        self.slots = cfg.slots // self.rows          # this rank's slots
        self.device = model.device
        self.cache = api.init_cache(
            model_cfg, cfg.slots, cfg.max_seq, self.device,
            grid=None if grid is None else grid.grid, seq_shard=seq_shard)
        self.pos = np.zeros((self.slots,), np.int32)     # next write position
        self.table = SlotTable(self.slots)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + self.row)

    @staticmethod
    def _check_grid(model_cfg, model, comm, grid) -> None:
        """Raise for a grid the engine does not serve on: a family the grid
        does not run (``api.check_grid_family``), a model that is not the
        rank's on a grid of model > 1 (nothing is replicated in its
        place), FSDP, or ``comm`` beside it."""
        if comm is not None:
            raise ValueError("comm= (experts over a 1-D world of ranks) and "
                             "grid= do not combine")
        api.check_grid_family(model_cfg, grid.grid)
        lay = model.layout
        if lay is None and grid.grid["model"] > 1:
            raise ValueError("on a grid with model > 1 the engine serves the "
                             "rank's model (api.grid_model), not a whole one")
        if lay is not None and lay.fsdp:
            raise ValueError(
                f"{model_cfg.name}: FSDP on a grid is not served by the "
                f"engine (its rows step independently; FSDP's gathers over "
                f"'data' need them in step) -- use api.prefill / "
                f"api.decode_step ({api.GRID_QUEUE})")

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
            tok = np.zeros((self.slots,), np.int32)
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
        """Every prompt's tokens (up to ``max_new`` each).  On a grid the
        rank's row serves prompts row, row + R, ...; every rank returns
        every request's tokens (:meth:`_join_rows`)."""
        if self.grid is None:
            return self._generate(prompts, max_new)
        mine = list(range(self.row, len(prompts), self.rows))
        outs = self._generate([prompts[i] for i in mine], max_new)
        return self._join_rows(len(prompts), mine, outs, max_new)

    def _join_rows(self, n: int, mine: list, outs: list,
                   max_new: int) -> list[list[int]]:
        """Every row's requests' tokens on every rank: a (n, max_new) table
        of -1 holding this row's, one max all-reduce over (pod, data)."""
        table = torch.full((n, max_new), -1, dtype=torch.int64)
        for i, out in zip(mine, outs):
            table[i, :len(out)] = torch.tensor(out, dtype=torch.int64)
        if self.rows > 1:
            table = self.grid.batch.all_reduce(table.to(self.device),
                                               op="max").cpu()
        return [[t for t in row if t >= 0] for row in table.tolist()]

    def _generate(self, prompts, max_new: int) -> list[list[int]]:
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
        return sample_tokens(logits, self.mc.vocab, self.cfg.temperature,
                             self._gen, self.model.layout)

    def _decode(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode call for every slot; the sampled tokens (slots,)."""
        logits, self.cache = api.decode_step(
            self.model, self.mc, self.cache,
            torch.from_numpy(tok).to(self.device),
            torch.from_numpy(pos).to(self.device), expert_comm=self.comm,
            seq_shard=self.seq_shard)
        return self._sample(logits)

    def _prefill(self, tokens: np.ndarray):
        return api.prefill(self.model, self.mc,
                           {"tokens": torch.from_numpy(tokens).to(
                               self.device)}, max_seq=self.cfg.max_seq,
                           comm=self.comm, replicated=True,
                           seq_shard=self.seq_shard)

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
