"""What a rank put on the wire: summaries of its collective calls, and a
tap that records every call into ``torch.distributed``.

The reference reads collectives out of compiled HLO text
(``repro.core.hlo_analysis``).  Nothing is compiled to text here, so the
record is the calls themselves:

* ``Comm.counters()`` (``core/engine.py``): the communication point's own
  record of its all-reduces and ring hops, their words, bytes and dtypes.
  It is what :func:`collective_summary` reads, in place of
  ``parse_collectives`` over HLO.
* :class:`WireTap`: every call into ``torch.distributed`` made in one
  process while the tap is open, wherever it was issued: calls and words
  by kind, in the same counter form less the bytes and dtypes, which are
  ``Comm``'s to record.  The contract pass opens it around each solve, so
  that a collective made outside ``Comm`` is counted too.

The reference's other parsers have no counterpart: ``parse_named_ops``
(transposes and gathers by result shape) is replaced by the contract pass's
check of the bound operand and, on the card, by peak allocated bytes
against the panel's and the operand's sizes; ``collective_dtypes`` by the
``dtypes`` of ``Comm``'s record.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


@dataclasses.dataclass(frozen=True)
class CollectiveSummary:
    """Calls by kind, their elements and bytes, and the dtypes moved.
    ``by_kind`` maps a kind (``"all_reduce"`` for a sum, ``"max"`` for a max
    all-reduce, ``"hop"``, ``"all_to_all"``, ``"all_gather"`` and
    ``"reduce_scatter"`` -- words
    as the elements this rank sent or contributed --, or the name of any
    other ``torch.distributed`` call a tap saw) to ``(calls, words)``.  A
    tap's record has no bytes or dtypes: 0 and the empty set."""
    count: int
    words: int
    bytes: int
    by_kind: dict
    dtypes: frozenset

    def calls(self, kind: str) -> int:
        return self.by_kind.get(kind, (0, 0))[0]

    def __str__(self) -> str:
        parts = [f"{k}: n={v[0]} words={v[1]}"
                 for k, v in sorted(self.by_kind.items())]
        moved = (f" bytes={self.bytes} dtypes={sorted(self.dtypes)}"
                 if self.dtypes else "")
        return (f"collectives n={self.count} words={self.words}{moved} | "
                + ("; ".join(parts) or "none"))


def _kinds(counters: dict) -> dict:
    n_max, w_max = counters.get("max_reduces", 0), counters.get("max_words", 0)
    kinds = {"all_reduce": (counters["all_reduces"] - n_max,
                            counters["words"] - w_max),
             "max": (n_max, w_max),
             "hop": (counters["hops"], counters["hop_words"]),
             "all_to_all": (counters.get("all_to_alls", 0),
                            counters.get("a2a_words", 0)),
             "all_gather": (counters.get("all_gathers", 0),
                            counters.get("gather_words", 0)),
             "reduce_scatter": (counters.get("reduce_scatters", 0),
                                counters.get("rs_words", 0))}
    for name, (n, w) in counters.get("other", {}).items():
        kinds[name] = (n, w)
    return {k: v for k, v in kinds.items() if v[0]}


def collective_summary(counters: dict) -> CollectiveSummary:
    """The summary of one counter record (``Comm.counters()`` or
    ``WireTap.counters()``)."""
    return summarize([counters])


def summarize(records: Iterable[dict]) -> CollectiveSummary:
    """The summary of several counter records added up (one rank's calls,
    or several calls of one rank)."""
    by_kind: dict[str, list] = {}
    nbytes = 0
    dtypes: set = set()
    for c in records:
        for k, (n, w) in _kinds(c).items():
            ent = by_kind.setdefault(k, [0, 0])
            ent[0] += n
            ent[1] += w
        nbytes += c.get("bytes", 0)
        dtypes.update(c.get("dtypes", ()))
    return CollectiveSummary(
        count=sum(n for n, _ in by_kind.values()),
        words=sum(w for _, w in by_kind.values()),
        bytes=nbytes, by_kind={k: tuple(v) for k, v in by_kind.items()},
        dtypes=frozenset(dtypes))


# The calls a tap wraps: every collective and point-to-point entry of
# torch.distributed.  isend / irecv are left alone: P2POp checks its op
# against them by identity; batch_isend_irecv sees their sends.
TAPPED = ("all_reduce", "all_gather", "all_gather_into_tensor",
          "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
          "batch_isend_irecv", "broadcast", "broadcast_object_list", "gather",
          "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor",
          "reduce_scatter_single", "scatter", "send")


# Calls a tap records under Comm's kind, with the words of the tensor this
# rank sends: (kind, its position, its keyword).
_SENT = {"all_to_all_single": ("all_to_all", 1, "input"),
         "all_gather": ("all_gather", 1, "tensor"),
         "reduce_scatter_tensor": ("reduce_scatter", 1, "input"),
         "reduce_scatter_single": ("reduce_scatter", 1, "input")}


def tensors(x) -> list:
    """The tensors of an argument: itself, or those of a list / tuple."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in tensors(item)]
    return []


class WireTap:
    """A context manager that counts every call into ``torch.distributed``
    made in this process while it is open (:data:`TAPPED`), whoever made
    it.  ``all_reduce`` counts as the kind ``"all_reduce"`` (``"max"``
    with ``op=ReduceOp.MAX``, also counted among the all-reduces, as
    ``Comm`` counts it), each send of
    ``batch_isend_irecv`` and each ``send`` as a ``"hop"``,
    ``all_to_all_single``, ``all_gather`` and ``reduce_scatter_tensor``
    (or ``reduce_scatter_single``) as ``"all_to_all"``, ``"all_gather"``
    and ``"reduce_scatter"`` with the words this rank sends, any other
    call under its own name.  :meth:`counters` has ``Comm.counters()``'s
    call and word keys (and ``"other"``)."""

    def __init__(self):
        self.all_reduces = self.words = 0
        self.max_reduces = self.max_words = 0
        self.hops = self.hop_words = 0
        self.other: dict[str, list] = {}
        self._saved = {}

    def _count(self, name: str, args, kwargs) -> None:
        import torch.distributed as dist
        if name == "batch_isend_irecv":
            sent = [op.tensor for op in args[0] if op.op is dist.isend]
            self.hops += len(sent)
            self.hop_words += sum(t.numel() for t in sent)
        else:
            moved = tensors(list(args) + list(kwargs.values()))
            words = sum(t.numel() for t in moved)
            if name == "all_reduce":
                self.all_reduces += 1
                self.words += words
                op = kwargs.get("op", args[1] if len(args) > 1 else None)
                if op == dist.ReduceOp.MAX:
                    self.max_reduces += 1
                    self.max_words += words
            elif name == "send":
                self.hops += 1
                self.hop_words += words
            elif name in _SENT:
                # the elements this rank sends, as Comm counts them
                kind, at, key = _SENT[name]
                sent = args[at] if len(args) > at else kwargs[key]
                ent = self.other.setdefault(kind, [0, 0])
                ent[0] += 1
                ent[1] += sent.numel()
            else:
                ent = self.other.setdefault(name, [0, 0])
                ent[0] += 1
                ent[1] += words

    def __enter__(self):
        import torch.distributed as dist
        for name in TAPPED:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def tapped(*args, _name=name, _fn=fn, **kwargs):
                self._count(_name, args, kwargs)
                return _fn(*args, **kwargs)
            setattr(dist, name, tapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved = {}

    def counters(self) -> dict:
        return {"all_reduces": self.all_reduces, "words": self.words,
                "max_reduces": self.max_reduces, "max_words": self.max_words,
                "hops": self.hops, "hop_words": self.hop_words,
                "other": {k: tuple(v) for k, v in self.other.items()}}


# ------------------------------------------------- the tensor-parallel pair --
# The autograd functions of a grid's layers (``models.api``): each forward
# and each backward collective goes through the group's ``Comm``, so both
# passes are counted (and seen by a WireTap).  A group of one is no group:
# the functions return their input.

class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward: the entry of
    a tensor-parallel region (its input replicated, its gradient a sum of
    the ranks' parts)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone(
            memory_format=torch.contiguous_format)), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the exit of a
    tensor-parallel region (the ranks' partial sums joined; every rank's
    copy of the sum takes the same gradient)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter of the gradient
    backward: a weight sharded over the group (FSDP) made whole for one
    use, its gradient summed over the group and cut back to the rank's
    block."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return torch.cat(comm.all_gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.stack(g.chunk(ctx.comm.size, dim=ctx.dim))
        return ctx.comm.reduce_scatter(parts), None, None


def copy_to(x: torch.Tensor, comm) -> torch.Tensor:
    """``x`` into a tensor-parallel region over ``comm``'s group."""
    return x if comm is None or comm.size == 1 else \
        _CopyToGroup.apply(x, comm)


def reduce_from(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum of the ranks' ``x`` out of a tensor-parallel region."""
    return x if comm is None or comm.size == 1 else \
        _ReduceFromGroup.apply(x, comm)


def gather_from(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    """The whole of a tensor sharded over ``comm``'s group along ``dim``."""
    return x if comm is None or comm.size == 1 else \
        _GatherFromGroup.apply(x, comm, dim)
