"""The plain reference against the program on the CPU at small sizes,
and that it imports nothing of the program, of JAX or of the JAX
package."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.manifest import load_module
from perfbench.tests.perfbench_tiny import ROOT, TINY_PORT

FAMILIES = sorted(p for p in (ROOT / "perfbench/reference").glob("*.py"))
STARCODER_LIKE = dict(TINY_PORT, arch_id="tiny-plain", num_heads=6,
                      num_kv_heads=2, d_model=96, gated=False,
                      activation="gelu_tanh", rope_base=1e6)


def _dense():
    return load_module(ROOT / "perfbench/reference/dense.py", "pb_ref_dense")


@pytest.mark.parametrize("port", [TINY_PORT, STARCODER_LIKE],
                         ids=["gated", "plain"])
def test_reference_matches_program_fp32(port):
    from repro_torch.models import build_model
    from repro_torch.models.common import ArchConfig

    port = dict(port, dtype="float32")
    ref_mod = _dense()
    specs = ref_mod.leaf_specs(port)
    model = build_model(ArchConfig(**port), device="cpu")
    weights.fill(dict(model.named_parameters()), specs, 77, port["num_layers"])
    tokens = torch.randint(0, port["vocab_size"], (1, 37),
                           generator=torch.Generator().manual_seed(1))
    want, _ = model.forward(tokens)
    ref = ref_mod.Reference(port, lambda n, l: weights.draw(
        77, n, l, specs[n], "cpu", torch.float32), "cpu", query_block=8)
    got = ref.logits([tokens[0]], [slice(0, 37)])[0]
    err = (got - want[0]).abs().max().item()
    assert err < 2e-4 * want.abs().max().item(), err


def test_reference_follows_served_tokens_through_paged_engine():
    """Prefill, pages and decode of the program (bf16, plain kernels on the
    CPU) against the reference on the consumed stream: the served greedy
    tokens are the reference's best or within bf16 rounding of it."""
    from perfbench import correct
    from repro_torch.models import build_model
    from repro_torch.models.common import ArchConfig
    from repro_torch.runtime.serve_loop import Request, Server, ServerConfig

    ref_mod = _dense()
    specs = ref_mod.leaf_specs(TINY_PORT)
    model = build_model(ArchConfig(**TINY_PORT), device="cpu")
    weights.fill(dict(model.named_parameters()), specs, 5, 2)
    server = Server(model, ServerConfig(max_batch=2, max_seq=96,
                                        kv_mode="paged", kv_pool_pages=24))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 32).astype(np.int32)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(
        0, 512, n).astype(np.int32)]), max_new_tokens=k, request_id=i)
        for i, (n, k) in enumerate([(20, 6), (9, 10), (30, 6)])]
    server.run(reqs)
    assert server.engine.serving_stats()["prefix_hits_total"] >= 1

    toks, rows, served = correct.streams(reqs, "cpu")
    ref = ref_mod.Reference(TINY_PORT, lambda n, l: weights.draw(
        5, n, l, specs[n], "cpu", torch.bfloat16), "cpu")
    gaps = correct.gaps_of_tokens(ref.logits(toks, rows), served)
    assert len(gaps) == 22 and gaps.max() < 0.1


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.stem)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "perfbench"}, tops


def test_reference_loads_no_program_module():
    code = (
        "import sys\n"
        "from perfbench.manifest import load_module\n"
        f"load_module(__import__('pathlib').Path({str(ROOT)!r}) / "
        "'perfbench/reference/dense.py', 'r')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fp8_control_rounds():
    ref_mod = _dense()
    x = torch.tensor([[1.0, 0.3, -0.7, 1e-3]])
    q = ref_mod._fp8(x, -1)
    assert q[0, 0] == 1.0 and (q - x).abs().max() < 0.05
    assert not torch.equal(q, x)
