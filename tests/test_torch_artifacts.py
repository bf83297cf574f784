"""The port's Artifact Repository (§V.B) under both sandbox policies.

Ops are callables on tensors, verified at registration by tracing them to
an aten graph; SELF images are loaded and checksummed through the port's
``ImageLoader``.  The maintainability claim: an op outside the legacy
allowlist (``erf``) registers under the modern policy with no config
change, is refused under the legacy one, and registers there only after
the allowlist edit the paper wants to eliminate.  Exact: no tolerance.
"""

import hashlib

import pytest
import torch

from repro_torch.checkpoint import save_tree
from repro_torch.core import (AdmissionController, ArtifactRepository,
                              ImageLoader, LegacyFilterPolicy,
                              ModernEmulationPolicy, Sandbox)
from repro_torch.core.elf import build_prophet_like

ARGS = (torch.linspace(-1.0, 1.0, 4),)


def _erf_softmax(x):
    return torch.softmax(torch.erf(x), dim=-1)


def test_new_op_registers_under_modern_and_not_legacy():
    legacy = ArtifactRepository(LegacyFilterPolicy())
    modern = ArtifactRepository(ModernEmulationPolicy())
    refused = legacy.register_op("erf_softmax", "1.0", _erf_softmax, ARGS)
    assert not refused.admitted and "erf" in refused.reason
    with pytest.raises(KeyError, match="not found"):
        legacy.resolve_op("erf_softmax", "1.0")
    rep = modern.register_op("erf_softmax", "1.0", _erf_softmax, ARGS)
    assert rep.admitted and rep.reason == "verified"
    assert dict(rep.artifact.primitive_histogram).get("aten.erf") == 1
    fn = modern.resolve_op("erf_softmax", "1.0")
    assert torch.allclose(fn(*ARGS).sum(), torch.tensor(1.0))
    assert modern.list() == [rep.artifact]
    # the legacy sandbox admits it only after an allowlist edit
    edited = ArtifactRepository(LegacyFilterPolicy().extended("aten.erf"))
    assert edited.register_op("erf_softmax", "1.0", _erf_softmax,
                              ARGS).admitted


def test_classic_op_registers_under_both():
    for policy in (LegacyFilterPolicy(), ModernEmulationPolicy()):
        repo = ArtifactRepository(policy)
        assert repo.register_op("softmax", "1.0",
                                lambda x: torch.softmax(x, dim=-1),
                                ARGS).admitted


def test_op_digest_follows_the_code():
    repo = ArtifactRepository(ModernEmulationPolicy())
    a = repo.register_op("f", "1", lambda x: x * 2, ARGS).artifact
    b = repo.register_op("f", "2", lambda x: x * 3, ARGS).artifact
    c = repo.register_op("f", "3", _erf_softmax, ARGS).artifact
    assert len(a.digest) == 16 and a.digest != c.digest
    assert repo.meta("f", "2") == b


def test_registration_prewarms_the_execution_cache():
    ctl = AdmissionController()
    repo = ArtifactRepository(ModernEmulationPolicy(), admission=ctl)
    assert repo.register_op("erf_softmax", "1.0", _erf_softmax,
                            ARGS).admitted
    sb = Sandbox(policy=ModernEmulationPolicy(), admission=ctl)
    out = sb.run(repo.resolve_op("erf_softmax", "1.0"), *ARGS)
    assert out.cache_hit and ctl.stats()["hits"] == 1


def test_images_are_loaded_and_checksummed():
    repo = ArtifactRepository(ModernEmulationPolicy())
    blob = save_tree({"w": torch.arange(12.0).reshape(3, 4)}, step=1)
    rep = repo.register_image("ckpt", "1", blob)
    assert rep.admitted and rep.artifact.kind == "self-image"
    assert rep.artifact.digest == hashlib.sha256(blob).hexdigest()[:16]
    assert repo.resolve_image("ckpt", "1") == blob
    assert repo.register_image("prophet", "1.1",
                               build_prophet_like()).admitted


def test_legacy_loader_refuses_the_prophet_image():
    repo = ArtifactRepository(ModernEmulationPolicy(),
                              loader=ImageLoader("legacy"))
    rep = repo.register_image("prophet", "1.1", build_prophet_like())
    assert not rep.admitted and rep.reason.startswith("load failed")
    with pytest.raises(KeyError):
        repo.resolve_image("prophet", "1.1")
