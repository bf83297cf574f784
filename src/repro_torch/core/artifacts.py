"""Artifact Repository — arbitrary user ops without allowlist churn (§V.B).

The paper's Artifact Repository lets users reference **any** PyPI package;
the modern sandbox makes that safe because the Sentry emulates whatever
syscalls the package performs — nobody edits a filter config.  Here users
register arbitrary **ops** (callables on tensors, admitted by tracing them
to an aten graph), or serialized SELF images.  The repository:

* content-hashes every artifact version (integrity),
* admits an op by running load-time verification against the sandbox
  policy **at registration**, recording the primitive histogram,
* demonstrates the maintainability claim directly: an op using a primitive
  outside the legacy allowlist registers fine under the modern policy and
  is rejected under the legacy one (``tests/test_torch_artifacts.py``).
"""

from __future__ import annotations

import hashlib
import pickle
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .admission import AdmissionController
from .loader import ImageLoader
from .policy import SandboxPolicy, SandboxViolation

__all__ = ["Artifact", "ArtifactRepository", "RegistrationReport"]


@dataclass(frozen=True)
class Artifact:
    name: str
    version: str
    digest: str
    kind: str                    # "op" | "self-image"
    primitive_histogram: Tuple[Tuple[str, int], ...] = ()


@dataclass
class RegistrationReport:
    artifact: Artifact
    admitted: bool
    reason: str


class ArtifactRepository:
    """Versioned registry of user-supplied ops and SELF images."""

    def __init__(
        self,
        policy: SandboxPolicy,
        loader: Optional[ImageLoader] = None,
        *,
        admission: Optional[AdmissionController] = None,
    ):
        self.policy = policy
        self.loader = loader or ImageLoader("linux")
        # registration-time verification populates the same cache the
        # execution layers read, so the first *run* of a registered op is
        # already a warm admission
        self.admission = admission or AdmissionController()
        self._ops: Dict[Tuple[str, str], Callable] = {}
        self._images: Dict[Tuple[str, str], bytes] = {}
        self._meta: Dict[Tuple[str, str], Artifact] = {}

    # ------------------------------------------------------------- register

    def register_op(
        self,
        name: str,
        version: str,
        fn: Callable,
        example_args: Tuple,
    ) -> RegistrationReport:
        """Register a user op; admission = load-time Sentry verification."""
        digest = _digest_callable(fn)
        try:
            ticket = self.admission.admit(
                fn, example_args,
                policy=self.policy,
                tenant=f"artifact:{name}",
                stage="register",
            )
            hist = dict(ticket.histogram)
        except SandboxViolation as e:
            art = Artifact(name, version, digest, "op")
            return RegistrationReport(art, False, str(e))
        art = Artifact(name, version, digest, "op", tuple(sorted(hist.items())))
        self._ops[(name, version)] = fn
        self._meta[(name, version)] = art
        return RegistrationReport(art, True, "verified")

    def register_image(self, name: str, version: str, blob: bytes) -> RegistrationReport:
        digest = hashlib.sha256(blob).hexdigest()[:16]
        try:
            self.loader.load(blob, verify=True)
        except Exception as e:
            art = Artifact(name, version, digest, "self-image")
            return RegistrationReport(art, False, f"load failed: {e}")
        art = Artifact(name, version, digest, "self-image")
        self._images[(name, version)] = blob
        self._meta[(name, version)] = art
        return RegistrationReport(art, True, "loaded and checksummed")

    # -------------------------------------------------------------- resolve

    def resolve_op(self, name: str, version: str) -> Callable:
        try:
            return self._ops[(name, version)]
        except KeyError:
            raise KeyError(f"artifact {name}=={version} not found") from None

    def resolve_image(self, name: str, version: str) -> bytes:
        return self._images[(name, version)]

    def meta(self, name: str, version: str) -> Artifact:
        return self._meta[(name, version)]

    def list(self) -> List[Artifact]:
        return [self._meta[k] for k in sorted(self._meta)]


def _digest_callable(fn: Callable) -> str:
    try:
        code = fn.__code__.co_code
    except AttributeError:
        code = pickle.dumps(getattr(fn, "__name__", repr(fn)))
    return hashlib.sha256(code).hexdigest()[:16]
