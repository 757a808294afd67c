"""The port's checkpoint manager: the reference's checkpoint cases on tensor
trees, and snapshots read across the two packages.

The cases mirror the reference's ``tests/test_checkpoint.py`` (round trip,
bf16, CRC fallback, keep-k, async, atomicity, the writer's two error
paths, a synchronous write error, a structure mismatch).  The cross-reads
write a tree with one package and restore it with the other, in f32 and
f64, and require the values bit for bit.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager, CheckpointWriteError

from _x64 import x64_mode  # noqa: F401  (autouse fixture: f64 cross-reads)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.zeros((16,), dtype=torch.bfloat16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _break_directory(path):
    """Replace the snapshot directory with a regular file, so that every
    write inside it fails (works under root, unlike permission bits)."""
    shutil.rmtree(path)
    with open(path, "w") as f:
        f.write("not a directory")


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state(3)
    mgr.save(3, state, {"data": {"step": 3}})
    restored, extra, step = mgr.restore_latest(_state(0))
    assert step == 3 and extra["data"]["step"] == 3
    _assert_tree_equal(state, restored)


def test_bf16_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.full((4,), 1.5, dtype=torch.bfloat16)})
    restored, _, _ = mgr.restore_latest({"w": torch.zeros(4)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.full((4,), 1.5))


def test_corruption_falls_back_to_older(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False, keep=5)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    d = os.path.join(str(tmp_path), "step_0000000002")
    leaf = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, leaf), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xde\xad\xbe\xef")
    restored, _, step = mgr.restore_latest(_state(0))
    assert step == 1                            # fell back
    assert int(restored["step"]) == 1


def test_keep_k_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state(7)
    mgr.save(7, state)
    state["params"]["w"].add_(1.0)      # the save copied the tree already
    mgr.wait()
    assert mgr.all_steps() == [7]
    restored, _, _ = mgr.restore_latest(_state(0))
    _assert_tree_equal(restored, _state(7))


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1))
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".tmp")]
    with open(os.path.join(str(tmp_path), "LATEST")) as f:
        assert f.read() == "step_0000000001"


def test_async_writer_error_surfaces_on_next_save(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, async_save=True)
    mgr.save(1, _state(1))
    mgr.wait()
    assert mgr.all_steps() == [1]
    _break_directory(d)
    mgr.save(2, _state(2))               # the writer thread fails ...
    with pytest.raises(CheckpointWriteError) as exc:
        mgr.save(3, _state(3))           # ... and this surfaces it
    assert exc.value.__cause__ is not None


def test_async_writer_error_surfaces_on_close(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, async_save=True)
    _break_directory(d)
    mgr.save(1, _state(1))
    with pytest.raises(CheckpointWriteError):
        mgr.close()
    mgr.close()                          # the error is consumed


def test_sync_save_raises_immediately(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, async_save=False)
    _break_directory(d)
    with pytest.raises(CheckpointWriteError):
        mgr.save(1, _state(1))


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1))
    assert mgr.restore_latest({"other": torch.zeros(3)}) is None


def test_restore_onto_a_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"x0": torch.arange(5.0)}, extra={"iters_done": 6})
    state, extra, _ = mgr.restore_latest({"x0": torch.zeros(5)},
                                         device="cpu")
    assert state["x0"].device.type == "cpu" and extra == {"iters_done": 6}


def _tree(dtype):
    rng = np.random.default_rng(4)
    return {"a": {"w": rng.standard_normal((3, 5)).astype(dtype),
                  "v": rng.standard_normal(7).astype(dtype)},
            "b": np.arange(4, dtype=np.int32)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_port_snapshot_restores_in_the_reference(tmp_path, dtype):
    tree = _tree(dtype)
    CheckpointManager(str(tmp_path), async_save=False).save(
        2, {"a": {k: torch.from_numpy(v) for k, v in tree["a"].items()},
            "b": torch.from_numpy(tree["b"])}, extra={"iters_done": 6})
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)
    restored, extra, step = JManager(str(tmp_path)).restore_latest(like)
    assert step == 2 and extra == {"iters_done": 6}
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_snapshot_restores_in_the_port(tmp_path, dtype):
    tree = jax.tree.map(jnp.asarray, _tree(dtype))
    JManager(str(tmp_path), async_save=False).save(5, tree,
                                                   extra={"cur_s": 3})
    like = {"a": {"w": torch.zeros(3, 5), "v": torch.zeros(7)},
            "b": torch.zeros(4)}
    restored, extra, step = CheckpointManager(str(tmp_path)).restore_latest(
        like)
    assert step == 5 and extra == {"cur_s": 3}
    want = _tree(dtype)
    for key in ("w", "v"):
        assert torch.equal(restored["a"][key], torch.from_numpy(
            want["a"][key]))
    assert torch.equal(restored["b"], torch.from_numpy(want["b"]))


def test_bf16_snapshot_crosses_both_ways(tmp_path):
    w = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        1, {"w": w})
    restored, _, _ = JManager(str(tmp_path / "port")).restore_latest(
        {"w": jax.ShapeDtypeStruct((3,), jnp.bfloat16)})
    assert restored["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(restored["w"], np.float32),
                          w.float().numpy())
    JManager(str(tmp_path / "ref"), async_save=False).save(
        1, {"w": jnp.asarray(w.float().numpy(), jnp.bfloat16)})
    back, _, _ = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        {"w": w})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
