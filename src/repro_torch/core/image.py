"""Sandbox base image — standardized runtime environment (paper §III.B).

The paper replaces an ad-hoc chroot with a predefined **base image** that
captures the binaries/libraries user code needs, decoupling user-code
dependencies from host dependencies.  Here the image pins everything a
sandboxed PyTorch workload depends on:

* the **op registry** (named callables available to user code — the
  "system libraries"),
* the **kernel implementation table** (``cuda``: the hand-written CUDA
  kernels on the card; ``eager``: their plain PyTorch versions),
* the **dtype policy** (param/compute/accum dtypes),
* **mesh defaults** for the engine the sandbox is colocated with.

Images are frozen and content-hashed; a :class:`Sandbox` bootstraps from an
image, never from ambient host state.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["DtypePolicy", "ImageSpec", "BaseImage", "DEFAULT_IMAGE"]


@dataclass(frozen=True)
class DtypePolicy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"

    def dtype(self, which: str) -> torch.dtype:
        return getattr(torch, getattr(self, f"{which}_dtype"))


@dataclass(frozen=True)
class ImageSpec:
    """Declarative image description (the 'Dockerfile')."""

    name: str
    version: str
    dtype_policy: DtypePolicy = DtypePolicy()
    kernel_impl: str = "eager"          # "eager" | "cuda"
    mesh_defaults: Tuple[Tuple[str, int], ...] = (("data", 16), ("model", 16))
    ops: Tuple[str, ...] = ()           # names resolved from the artifact repo
    env: Tuple[Tuple[str, str], ...] = ()

    def digest(self) -> str:
        payload = json.dumps(
            {
                "name": self.name,
                "version": self.version,
                "dtype_policy": vars(self.dtype_policy),
                "kernel_impl": self.kernel_impl,
                "mesh_defaults": list(self.mesh_defaults),
                "ops": list(self.ops),
                "env": list(self.env),
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(payload).hexdigest()[:16]


class BaseImage:
    """A bootstrapped, immutable runtime environment."""

    def __init__(
        self,
        spec: ImageSpec,
        op_registry: Optional[Mapping[str, Callable]] = None,
    ) -> None:
        self.spec = spec
        self._ops: Dict[str, Callable] = dict(op_registry or {})
        missing = [o for o in spec.ops if o not in self._ops]
        if missing:
            raise KeyError(f"image {spec.name}:{spec.version} missing ops {missing}")

    @property
    def digest(self) -> str:
        return self.spec.digest()

    def op(self, name: str) -> Callable:
        try:
            return self._ops[name]
        except KeyError:
            raise KeyError(
                f"op {name!r} not in base image {self.spec.name}:{self.spec.version}"
            ) from None

    def with_ops(self, **ops: Callable) -> "BaseImage":
        """Derive a new image layer (images are immutable)."""
        merged = dict(self._ops)
        merged.update(ops)
        new_spec = replace(self.spec, ops=tuple(sorted(set(self.spec.ops) | set(ops))))
        return BaseImage(new_spec, merged)

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.spec.name,
            "version": self.spec.version,
            "digest": self.digest,
            "kernel_impl": self.spec.kernel_impl,
            "ops": sorted(self._ops),
        }


def _default_ops() -> Dict[str, Callable]:
    return {
        "torch.mean": torch.mean,
        "torch.sum": torch.sum,
        "torch.matmul": torch.matmul,
        "torch.softmax": torch.softmax,
        "torch.nn.functional.gelu": torch.nn.functional.gelu,
    }


DEFAULT_IMAGE = BaseImage(
    ImageSpec(
        name="see-base",
        version="2025.07",
        ops=tuple(sorted(_default_ops())),
    ),
    _default_ops(),
)
