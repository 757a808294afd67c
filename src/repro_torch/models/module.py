"""Parameter trees described by ParamSpec, the twin of ``repro.models.module``.

Every model declares a nested dict of :class:`ParamSpec` (shape, logical
axes, dtype, init).  From that one description come the parameter count and
bytes and the materialised parameters (:func:`init_params`), so shapes and
initialisation cannot drift apart.  The reference's ``abstract_params`` (the
shardings of its compile-only dry run) has no twin here.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis names, len == ndim
    dtype: Any = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones
    scale: float | None = None        # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree, is_leaf=is_spec):
    """``fn`` over the leaves of a nested dict, keeping its structure."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, is_leaf=is_spec) -> list:
    """The leaves of a nested dict, keys in sorted order (as ``jax.tree``
    flattens a dict)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return [leaf for k in sorted(tree) for leaf in
                tree_leaves(tree[k], is_leaf)]
    return [tree]


def tree_items(tree, is_leaf=is_spec, path: str = ""):
    """``(path, leaf)`` over a nested dict in :func:`tree_leaves` order,
    the path its keys joined by ``/``."""
    if isinstance(tree, dict) and not is_leaf(tree):
        for k in sorted(tree):
            yield from tree_items(tree[k], is_leaf,
                                  f"{path}/{k}" if path else k)
    else:
        yield path, tree


def tensor_leaves(tree) -> list:
    """The tensor leaves of a nested dict of tensors, in
    :func:`tree_leaves` order."""
    return tree_leaves(tree, is_leaf=torch.is_tensor)


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension (the layer axis of the parameter
    layout)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.dtype,
                            s.init, s.scale), tree)


def _init_one(spec: ParamSpec, generator: torch.Generator, device,
              experts: tuple | None = None) -> torch.Tensor:
    """One leaf of ``spec``, one draw.  With ``experts=(lo, hi)`` a leaf
    with an ``"expert"`` axis is drawn one expert's matrix at a time
    (leading axes in order) and only those experts are kept: that stream
    is the same for every cut, and the draw never holds more than one
    matrix beyond the kept ones."""
    shape = spec.shape
    ax = (spec.axes.index("expert")
          if experts is not None and "expert" in spec.axes else None)
    if ax is not None:
        lo, hi = experts
        shape = shape[:ax] + (hi - lo,) + shape[ax + 1:]
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    # fan-in scaled normal: last-but-one axis is the contraction by convention
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(
        max(fan_in, 1))
    if ax is None:
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x.mul_(scale)).to(spec.dtype)
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    x = torch.empty(spec.shape[ax + 1:], dtype=torch.float32, device=device)
    for idx in itertools.product(*map(range, spec.shape[:ax + 1])):
        x.normal_(generator=generator)
        if lo <= idx[-1] < hi:
            out[idx[:-1] + (idx[-1] - lo,)] = x.mul_(scale)
    return out


def init_params(tree, generator: torch.Generator, device=None,
                experts: tuple | None = None):
    """Materialise a ParamSpec tree into tensors on ``device`` (default:
    the generator's), drawn in f32 from ``generator`` leaf by leaf in the
    tree's sorted-key order, scaled, then cast to each spec's dtype, as
    the reference does.  The stream is ``torch``'s, not ``jax.random``'s:
    the two packages' weights differ for the same seed by design, and
    parity tests hand both the same numpy weights instead.
    ``experts=(lo, hi)``: each expert leaf is drawn one expert's matrix at
    a time (a stream of its own) and keeps only those experts, so the
    shards of any number of ranks join into the ``(0, E)`` draw
    (``api.init_shard``)."""
    device = generator.device if device is None else torch.device(device)
    drawn = {path: _init_one(s, generator, device, experts)
             for path, s in _paths(tree)}
    return _unflatten(tree, drawn)


def _paths(tree, prefix=()):
    if isinstance(tree, dict) and not is_spec(tree):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _unflatten(tree, values, prefix=()):
    if isinstance(tree, dict) and not is_spec(tree):
        return {k: _unflatten(v, values, prefix + (k,))
                for k, v in tree.items()}
    return values[prefix]


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(tree))
