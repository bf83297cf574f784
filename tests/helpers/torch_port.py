"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*).

Both packages get the same inputs: numpy arrays made from a seed, and the
reference's ``init(PRNGKey(0))`` weights converted with
``repro_torch.models.params_from_numpy``.  Parity runs at fp32 on the CPU.
"""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.models import build_model, params_from_numpy

# the tier-1 run uses xdist with 6 workers: keep each one's intra-op pool small
torch.set_num_threads(2)

__all__ = ["fp32_config", "model_pair", "to_numpy", "to_torch"]


def fp32_config(arch: str, **overrides):
    """The reference's reduced config of ``arch`` at fp32, with overrides."""
    return dataclasses.replace(jax_get_reduced(arch), dtype="float32",
                               **overrides)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr))


def model_pair(cfg, **jax_kw):
    """(jax model, jax params, torch model) with the same weights, each
    built by its package's ``build_model`` (``jax_kw``, e.g. ``impl``, go
    to the reference's).

    ``cfg`` is a reference ``ArchConfig``; the port gets the same fields.
    """
    from repro_torch.models.common import ArchConfig

    jax_model = jax_build_model(cfg, **jax_kw)
    params = jax_model.init(jax.random.PRNGKey(0))
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, to_numpy(params)))
    return jax_model, params, model
