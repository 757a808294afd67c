"""Fault-tolerant snapshots of tensor trees.

Guarantees (tested in tests/test_torch_checkpoint.py):
  * **Atomicity**: a snapshot directory appears only after a completed write
    (written to ``<step>.tmp``, then renamed); the LATEST pointer is written
    to a temporary file and renamed as well, so a crash during a save never
    corrupts the restore path.
  * **Integrity**: a CRC32 of every leaf in the manifest; restore checks it
    and falls back to the next-older snapshot if a leaf fails (bit rot, a
    write truncated by a node failure).
  * **Exact resume**: user extras (the iteration reached, the data stream's
    state) ride in the manifest.
  * **Async**: a save copies the tree to the host at once and writes it on
    a writer thread; ``keep`` snapshots are kept after each commit.
  * **No silent writer death**: an exception on the writer thread is
    re-raised as :class:`CheckpointWriteError` on the next ``save()``,
    ``wait()`` or ``close()``.

The layout is the reference package's (``repro.checkpoint``): one
``leaf_<i>.npy`` per leaf, leaves numbered in the order ``jax.tree.flatten``
gives (dict keys sorted, lists and tuples in order), and the same manifest,
so a snapshot written by either package restores in the other.  bfloat16,
which numpy has no type for, is stored as its raw 2-byte words and named
``bfloat16`` in the manifest.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib

import numpy as np
import torch

_log = logging.getLogger(__name__)


def _flatten(tree) -> tuple[list, object]:
    """(leaves, treedef) of a tree of dicts, lists and tuples; dict keys
    sorted, None an empty subtree, anything else a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (list if isinstance(tree, list) else tuple, None,
                 [p[1] for p in parts]))
    if tree is None:
        return [], None
    return [tree], "leaf"


def _unflatten(treedef, leaves):
    """The tree of :func:`_flatten`'s ``treedef`` over the iterator
    ``leaves``."""
    if treedef == "leaf":
        return next(leaves)
    if treedef is None:
        return None
    kind, keys, children = treedef
    built = [_unflatten(c, leaves) for c in children]
    return dict(zip(keys, built)) if kind == "dict" else kind(built)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of the tensor ``leaf`` and its dtype's manifest name."""
    t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t if device is None else t.to(device)


class CheckpointWriteError(RuntimeError):
    """A snapshot write failed.  For an async save this surfaces on the NEXT
    ``save()`` / ``wait()`` / ``close()``, with the writer thread's exception
    chained as ``__cause__``."""


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._writer: threading.Thread | None = None
        self._writer_step: int | None = None
        self._pending_error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, state, extra: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``state`` (a tree of tensors) as ``step``.  The tree is
        copied to the host before this returns; the write runs on the
        writer thread unless ``block`` or the manager is synchronous."""
        self.wait()    # one save in flight at a time; raises a past failure
        leaves, _ = _flatten(state)
        host = [_to_numpy(leaf) for leaf in leaves]
        if self.async_save and not block:
            self._writer_step = step
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, host, extra or {}),
                daemon=True)
            self._writer.start()
        else:
            try:
                self._write(step, host, extra or {})
            except Exception as e:
                raise CheckpointWriteError(
                    f"checkpoint write for step {step} failed") from e

    def _write_guarded(self, step: int, host: list, extra: dict) -> None:
        # On the writer thread an uncaught exception would die with the
        # thread and the caller would believe the snapshot landed: keep it
        # for wait() to raise on the caller's thread.
        try:
            self._write(step, host, extra)
        except BaseException as e:
            self._pending_error = e

    def _raise_pending(self) -> None:
        if self._pending_error is not None:
            e, self._pending_error = self._pending_error, None
            raise CheckpointWriteError(
                f"async checkpoint write for step {self._writer_step} "
                "failed") from e

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_pending()

    def close(self) -> None:
        """Drain the writer and raise a failure it kept.  Call at the end of
        a job, or a failed last snapshot shows only at the next save."""
        self.wait()

    def _write(self, step: int, host: list, extra: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (arr, dtype) in enumerate(host):
            fname = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": str(i), "file": fname, "shape": list(arr.shape),
                "dtype": dtype,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes())})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        ptr_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._prune()

    def _prune(self) -> None:
        for s in self.all_steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def restore_latest(self, like, device=None):
        """Restore the newest valid snapshot.

        ``like`` is a tree of the target structure (its leaves are not
        read).  The leaves come back as tensors on ``device`` (``None``: the
        CPU).  Returns ``(state, extra, step)``, or None if no snapshot is
        valid.
        """
        for step in reversed(self.all_steps()):
            try:
                return self._restore(step, like, device)
            except Exception as e:              # corrupt: try the older
                _log.warning("checkpoint step %d unusable (%s); trying older",
                             step, e)
        return None

    def _restore(self, step: int, like, device):
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = _flatten(like)
        paths = [str(i) for i in range(len(leaves))]
        by_path = {entry["path"]: entry for entry in manifest["leaves"]}
        if set(paths) != set(by_path):
            raise ValueError("checkpoint structure mismatch")
        tensors = []
        for p in paths:
            entry = by_path[p]
            arr = np.load(os.path.join(d, entry["file"]))
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != entry["crc"]:
                raise OSError(f"crc mismatch in leaf {p}")
            tensors.append(_to_tensor(arr, entry["dtype"], device))
        return _unflatten(treedef, iter(tensors)), manifest["extra"], step
