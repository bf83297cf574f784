"""Shared checks for the port's training parity tests
(tests/test_torch_train*.py): seeded batches for every family, and one
family's ``loss`` with all of its gradients held to
``jax.value_and_grad`` of the reference's (tolerances: see
tests/test_torch_train_loss.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers.torch_port import fp32_config, model_pair
from repro.checkpoint.ckpt import tree_to_records as ref_records
from repro_torch.models.common import param_tree
from repro_torch.runtime.train_loop import backward
from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like

__all__ = ["LOSS_RTOL", "GRAD_REL", "batch_for", "check_loss_and_grads"]

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def batch_for(cfg, B=2, seed=0):
    """Seeded tokens, targets and a ragged loss mask (+ patch embeddings
    for the VLM, frames for whisper)."""
    # the reference's scans need 64 to divide T past 64 tokens
    S = 64 if cfg.family in ("ssm", "hybrid") else 16
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def check_loss_and_grads(arch: str) -> None:
    cfg = fp32_config(arch)
    jax_model, params, model = model_pair(cfg)
    batch = batch_for(cfg)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        jax_model.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    tree = param_tree(model)
    flat = tree_flatten_with_path(tree)
    leaves = [t.clone().requires_grad_(True) for _, t in flat]
    loss, metrics = model.loss(tree_unflatten_like(tree, leaves),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = backward(loss, leaves)

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(ref_metrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    want = dict(ref_records(ref_grads))
    assert len(want) == len(flat)
    for (path, _), g in zip(flat, grads):
        key = "/".join(map(str, path))
        ref = np.asarray(want[key])
        assert g.shape == ref.shape, key
        scale = float(np.abs(ref).max())
        assert scale > 0, f"{key}: the reference's gradient is zero"
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= GRAD_REL * scale + 1e-7, (key, err, scale)
