"""The transformer families' ``loss`` and all of its gradients against
``jax.value_and_grad`` of the reference's ``loss``, fp32 on the CPU (the
recurrent, hybrid, MoE and enc-dec families are in
tests/test_torch_train_loss_families.py).

The port's ``loss(params, batch)`` takes the reference's parameter tree
(the port model's ``param_tree``, loaded from the reference's ``init``
output) and runs the reference's training route (``blockwise_attn``, the
XLA ``wkv6_scan`` and ``ssm_scan`` counterparts), grad-enabled, with
activation checkpointing.  The batches are seeded numpy arrays with a
ragged loss mask, patch embeddings for the VLM and frames for whisper.

Tolerances: the loss within rtol 1e-5, and every gradient leaf within
``1e-4 * max|g_ref|`` elementwise.  Both sides sum in fp32 in different
orders (ATen against XLA); the largest difference seen over these cases
is 1.3e-5 of the leaf's largest entry (RWKV, where the per-head group
norm's small variances amplify reordering: on a structured batch both
sides stray from an fp64 run by 2e-4 to 8e-4, the port the nearer).
"""

import pytest
import torch

from helpers.torch_port import fp32_config, model_pair
from helpers.torch_train import batch_for, check_loss_and_grads
from repro_torch.models.common import param_tree

# dense (gemma2: windows and softcaps; starcoder2: plain MLP and biases),
# MoE with sigmoid top-1, a shared expert and an untied unembedding
# (llama4), and the VLM prefix (llava)
ARCHS = ["gemma2-9b", "starcoder2-7b", "llama4-scout-17b-a16e",
         "llava-next-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_loss_never_reaches_the_flash_kernel(monkeypatch):
    """The training route is ``blockwise_attn``: the prefill wrapper,
    which would dispatch to K2 (no backward) on the card, is not called."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def refuse(*a, **k):
        raise AssertionError("loss went through flash_attention")

    monkeypatch.setattr(fa_ops, "flash_attention", refuse)
    cfg = fp32_config("gemma2-9b")
    _, _, model = model_pair(cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    loss, _ = model.loss(param_tree(model), batch)
    assert torch.isfinite(loss)
