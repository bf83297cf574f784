"""The port's SELF checkpoints against the reference's.

The same tree saved by ``repro.checkpoint.save_tree`` and by
``repro_torch.checkpoint.save_tree`` gives the same bytes (leaf keys,
segment order, lane padding, manifest, bf16 as raw 16-bit words), each
package restores the other's blob bit for bit, the legacy loader fails on
both with ``SegfaultError``, and the port's ``CheckpointManager`` keeps
the reference's lifecycle.  Everything is exact: no tolerance.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_port import fp32_config, model_pair, to_numpy
from repro.checkpoint import load_tree as ref_load_tree
from repro.checkpoint import save_tree as ref_save_tree
from repro.configs import get_reduced as ref_get_reduced
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import (CheckpointManager, load_tree,
                                    records_to_tree, save_tree,
                                    tree_to_records)
from repro_torch.core.elf import read_self
from repro_torch.core.gofer import CapabilityError, Gofer
from repro_torch.core.loader import SegfaultError
from repro_torch.models.common import param_tree
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves


def _np_tree(rng):
    """fp32 with an odd last dim, bf16, int32 and a scalar ``step``."""
    return {
        "w": rng.standard_normal((33, 70)).astype(np.float32),
        "b": {"x": rng.standard_normal((5,)).astype(np.float32),
              "y": np.arange(12, dtype=np.int32).reshape(3, 4)},
        "h": np.asarray(jnp.asarray(rng.standard_normal((17, 130)),
                                    jnp.bfloat16)),
        "opt": {"step": np.asarray(7, np.int32)},
        "scalar": np.float32(3.5),
    }


def _torch_leaf(arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_torch(tree):
    return jax.tree_util.tree_map(_torch_leaf, tree)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.uint16)
    return x.tobytes()


def _assert_same_leaves(got, want):
    got_leaves = tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(np.shape(g)) == tuple(np.shape(w))
        assert _bits(g) == _bits(w)


def test_blobs_are_byte_identical(rng):
    tree = _np_tree(rng)
    extra = {"note": "hi", "arch": "smoke"}
    assert save_tree(_to_torch(tree), step=7, extra=extra) == \
        ref_save_tree(tree, step=7, extra=extra)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_state_blobs_are_byte_identical(dtype):
    """A real training tree: the reference's ``init`` output and its AdamW
    state beside the port's ``param_tree`` of the same weights."""
    cfg = fp32_config("gemma2-9b") if dtype == "float32" else \
        dataclasses.replace(ref_get_reduced("gemma2-9b"))
    jax_model, params, model = model_pair(cfg)
    ours = {"params": param_tree(model)}
    ours["opt"] = adamw_init(ours["params"])
    theirs = {"params": params, "opt": ref_adamw_init(params)}
    assert save_tree(ours, step=3) == ref_save_tree(theirs, step=3)
    keys = [k for k, _ in tree_to_records(ours)]
    assert keys[0] == "opt/mu/embed" and "params/layers/attn/wq" in keys
    assert keys == sorted(keys)


def test_each_package_loads_the_others_blob(rng):
    tree = _np_tree(rng)
    ref_blob = ref_save_tree(tree, step=2)
    port_blob = save_tree(_to_torch(tree), step=2)
    got, manifest = load_tree(ref_blob, _to_torch(tree))
    assert manifest["step"] == 2
    _assert_same_leaves(got, tree)
    assert got["h"].dtype == torch.bfloat16
    back, _ = ref_load_tree(port_blob, tree)
    _assert_same_leaves(_to_torch(back), tree)
    assert np.asarray(back["h"]).dtype == jnp.bfloat16


def test_records_without_a_like_tree(rng):
    tree = _np_tree(rng)
    records, manifest = load_tree(save_tree(_to_torch(tree)))
    assert set(records) == {"w", "b/x", "b/y", "h", "opt/step", "scalar"}
    assert records["opt/step"].shape == () and \
        records["opt/step"].dtype == torch.int32
    assert [t["key"] for t in manifest["tensors"]] == sorted(records)


@pytest.mark.parametrize("save", [save_tree, ref_save_tree])
def test_legacy_semantics_segfault(rng, save):
    tree = _np_tree(rng)
    blob = save(_to_torch(tree) if save is save_tree else tree)
    with pytest.raises(SegfaultError):
        load_tree(blob, semantics="legacy")


def test_memsz_padding_present(rng):
    blob = save_tree({"w": torch.zeros((8, 70))})
    seg = read_self(blob).phdrs[0]
    assert seg.p_memsz == 8 * 128 * 4 > seg.p_filesz == 8 * 70 * 4


def test_shape_mismatch_and_missing_keys_are_refused(rng):
    tree = _to_torch(_np_tree(rng))
    blob = save_tree(tree)
    with pytest.raises(ValueError, match="checkpoint shape"):
        load_tree(blob, dict(tree, w=torch.zeros((10, 10))))
    with pytest.raises(KeyError, match="missing tensor"):
        records_to_tree({}, {"w": torch.zeros(2)})


def test_manager_lifecycle(tmp_path, rng):
    g = Gofer.for_root("ckpt", tmp_path, write=True)
    mgr = CheckpointManager(g, keep=2, keep_every=20)
    tree = _to_torch(_np_tree(rng))
    for step in (10, 20, 30, 40):
        mgr.save(step, tree, blocking=True)
    assert mgr.all_steps() == [20, 30, 40]       # keep=2 + keep_every 20
    assert mgr.latest_step() == 40
    step, out, manifest = mgr.restore_latest(tree, device="cpu")
    assert step == 40 and manifest["step"] == 40
    _assert_same_leaves(out, _np_tree(np.random.default_rng(0)))


def test_manager_async_save_snapshots_at_save(tmp_path):
    """The write runs on a thread, one in flight; the values written are
    those at ``save``, whatever the caller does to its tensors after."""
    g = Gofer.for_root("ckpt", tmp_path, write=True)
    mgr = CheckpointManager(g)
    w = torch.ones(4, 4)
    gate = threading.Event()
    real = g.write_bytes

    def slow_write(*args):
        gate.wait(5)
        real(*args)

    g.write_bytes = slow_write
    mgr.save(5, {"w": w})
    w.fill_(2.0)                         # an in-place step right after
    gate.set()
    mgr.wait()
    assert mgr.latest_step() == 5
    assert mgr.save_log and mgr.save_log[0]["bytes"] > 0
    _, out, _ = mgr.restore_latest({"w": w})
    assert torch.equal(out["w"], torch.ones(4, 4))


def test_manager_reads_a_reference_checkpoint(tmp_path, rng):
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.core.gofer import Gofer as RefGofer

    tree = _np_tree(rng)
    RefManager(RefGofer.for_root("ckpt", tmp_path, write=True)).save(
        9, tree, blocking=True)
    mgr = CheckpointManager(Gofer.for_root("ckpt", tmp_path))
    step, out, _ = mgr.restore_latest(_to_torch(tree))
    assert step == 9
    _assert_same_leaves(out, tree)


def test_gofer_capability_enforced(tmp_path):
    g = Gofer.for_root("ckpt", tmp_path, write=False)
    with pytest.raises(CapabilityError):
        g.write_bytes("ckpt", "x.bin", b"data")
    with pytest.raises(CapabilityError):
        g.read_bytes("ckpt", "../../etc/passwd")
    with pytest.raises(CapabilityError):
        CheckpointManager(g).save(1, {"w": torch.zeros(2)}, blocking=True)


def test_jax_leaves_are_accepted_as_numpy(rng):
    """A tree of the reference's own arrays (``to_numpy`` of jax arrays,
    bf16 included) saves to the reference's bytes."""
    tree = {"p": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "q": jnp.arange(4, dtype=jnp.int32)}
    assert save_tree(to_numpy(tree)) == ref_save_tree(tree)
