"""The MoE (qwen3-moe: softmax top-k with the router's aux loss in the
total), RWKV6, hybrid and enc-dec families' ``loss`` and all of its
gradients against ``jax.value_and_grad`` of the reference's ``loss``, fp32
on the CPU, with the tolerances of tests/test_torch_train_loss.py."""

import pytest

from helpers.torch_train import check_loss_and_grads


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "rwkv6-3b",
                                  "hymba-1.5b", "whisper-tiny"])
def test_loss_and_every_gradient_match_the_reference(arch):
    check_loss_and_grads(arch)
