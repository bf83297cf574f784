"""Checkpointing on the SELF format — the paper's loader in the real path.

The counterpart of ``repro/checkpoint/ckpt.py`` over nested dicts of torch
tensors.  Every checkpoint is a SELF image: one LOAD segment per tensor
with ``filesz`` = actual bytes and ``memsz`` = lane-tile-padded bytes, plus
a ``DYNAMIC``-style JSON manifest section that lives in the page-aligned
tail of the last segment — the exact layout class the paper's §IV.B bug
corrupted.  Restoring with ``ImageLoader("legacy")`` reproduces the
paper's prophet failure on real checkpoints.

A leaf is named as the reference names it: its path of dict keys (list
indices) joined with ``/``, dict keys visited in sorted order, as
``jax.tree_util`` flattens them (``params/layers/attn/wq``,
``opt/mu/embed``).  The manifest's dtype is the numpy name
(``"float32"``, ``"bfloat16"``), and bf16 is stored as its raw 16-bit
words, so the same tree gives a byte-identical blob in both packages and
each loads the other's.  Leaves may be tensors on any device, numpy
arrays or numpy scalars; restored leaves are CPU tensors.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.elf import LANE_TILE, PT_DYNAMIC, SELFWriter
from repro_torch.core.loader import ImageLoader
from repro_torch.tree import tree_flatten_with_path

__all__ = ["save_tree", "load_tree", "tree_to_records", "records_to_tree"]

POINTER_LEN = 96

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "uint32": torch.uint32,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "uint16": torch.uint16,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _key(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def _as_tensor(leaf) -> torch.Tensor:
    """A CPU tensor of ``leaf``'s values (numpy leaves keep their dtype)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":        # ml_dtypes: torch has no mapping
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    """A tensor of its own (torch's allocator, so aligned as any other:
    a math library's results may depend on alignment) holding ``data``."""
    out = torch.empty(shape, dtype=_DTYPES[dtype])
    if data:
        out.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
            data, np.uint8)
    return out


def tree_to_records(tree) -> List[Tuple[str, torch.Tensor]]:
    return [(_key(path), _as_tensor(leaf))
            for path, leaf in tree_flatten_with_path(tree)]


def records_to_tree(records: Dict[str, torch.Tensor], like):
    """``like``'s structure with each leaf taken from ``records`` by its
    key; a missing key or another shape is refused."""

    def build(node, prefix):
        if node is None:
            return None
        if not isinstance(node, (Mapping, list, tuple)):
            key = _key(prefix)
            if key not in records:
                raise KeyError(f"checkpoint missing tensor {key!r}")
            arr = records[key]
            if tuple(arr.shape) != tuple(np.shape(node)):
                raise ValueError(
                    f"{key}: checkpoint shape {tuple(arr.shape)} != "
                    f"expected {tuple(np.shape(node))}")
            return arr
        if isinstance(node, Mapping):
            return {k: build(node[k], prefix + (k,)) for k in sorted(node)}
        return type(node)(build(v, prefix + (i,)) for i, v in enumerate(node))

    return build(like, ())


# --------------------------------------------------------------------------
# SELF images
# --------------------------------------------------------------------------


def save_tree(tree, *, step: int = 0, extra: Optional[dict] = None) -> bytes:
    """Serialize a tree (or shard of one) into a SELF image."""
    records = tree_to_records(tree)
    w = SELFWriter()
    manifest = {"step": step, "tensors": [], "extra": extra or {}}
    for key, t in records:
        data = _to_bytes(t)
        itemsize = max(t.element_size(), 1)
        # in-memory (device) size: last dim padded to the 128-lane tile
        if t.dim():
            padded_last = -(-max(t.shape[-1], 1) // LANE_TILE) * LANE_TILE
            mem_elems = math.prod(t.shape[:-1]) * padded_last
        else:
            mem_elems = LANE_TILE
        memsz = max(mem_elems * itemsize, len(data))
        ph = w.add_segment(data, memsz=memsz)
        manifest["tensors"].append({
            "key": key,
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "vaddr": ph.p_vaddr,
            "nbytes": len(data),
            "memsz": memsz,
        })
    # manifest as a DYNAMIC-style section in the page-aligned tail of a
    # final, small segment (the paper's Fig. 4 layout, exercised on every
    # checkpoint save/restore).
    mbytes = json.dumps(manifest).encode()
    mseg = w.add_segment(mbytes)                   # manifest body: own LOAD
    # DYNAMIC *pointer* lives in the page-aligned extension of a tiny
    # anchor segment: data is 9 bytes, memsz 16, so linux semantics zero
    # exactly [9,16) and the pointer at vaddr+16 survives; legacy
    # semantics zero to the page end and wipe it (paper §IV.B) — every
    # checkpoint restore exercises the fix.
    pointer = json.dumps(
        {"manifest_vaddr": mseg.p_vaddr, "manifest_len": len(mbytes)}
    ).encode().ljust(POINTER_LEN, b" ")
    anchor = w.add_segment(b"SEE++ckpt", memsz=16, tail=b"\0" * 7 + pointer)
    w.add_section("DYNAMIC", PT_DYNAMIC, anchor.p_vaddr + 16, pointer)
    return w.finish()


def load_tree(blob: bytes, like=None, *, semantics: str = "linux"):
    """Restore a tree from a SELF image: ``(records, manifest)``, or with
    ``like`` given ``(tree, manifest)``.

    ``semantics="legacy"`` reproduces the paper's bug: the page-extension
    zeroing destroys the manifest → :class:`SegfaultError`.
    """
    loader = ImageLoader(semantics)
    img = loader.load(blob, verify=True)
    pointer = json.loads(img.section_bytes("DYNAMIC"))
    manifest = json.loads(
        img.read(pointer["manifest_vaddr"], pointer["manifest_len"])
    )
    records: Dict[str, torch.Tensor] = {}
    for t in manifest["tensors"]:
        data = img.read(t["vaddr"], t["nbytes"])
        records[t["key"]] = _from_bytes(data, t["dtype"], t["shape"])
    if like is None:
        return records, manifest
    return records_to_tree(records, like), manifest
