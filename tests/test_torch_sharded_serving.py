"""Port parity: tensor-parallel serving on a mesh (``repro_torch.launch.mesh``,
``paged_attention_sharded``, ``ServingEngine(mesh=)``) against the
reference's, case for case of ``tests/test_sharded_serving.py``.

The reference splits the host CPU into 4 XLA devices; the port's mesh is 2
or 4 shard worker processes on host slots (gloo), started once per mesh
and shared by this module's engines (``helpers.torch_serving.port_mesh``).

* The integer ``ToyLM`` and its torch twin serve the same seeded workload
  on 1-, 2- and 4-rank meshes, paged and dense, sharing on and off: the
  port's streams equal its no-mesh run's, and streams, traces, stats and
  ledgers equal the reference's mesh engine's byte for byte (the only
  cross-rank sum is of integers).  A mesh of 3 falls back as the
  reference's does, with the same ``tp_fallback`` trace lines.
* ``paged_attention_sharded`` over 2 and 4 ranks is bit-identical to the
  unsharded call and within 2e-5 of the reference's sharded kernel (run in
  interpret mode, as the reference's tests run it), with dead rows and the
  fallback for heads that do not divide.
* A reduced qwen2.5 with 4 kv heads: the port's sharded decode step
  against its unsharded step and the reference's ``shard_map``'d step, at
  fp32.  The wo product is summed over ranks in another order than one
  GEMM sums it (the reference's XLA keeps it bit-exact; torch does not), so
  logits and pools are held to ``rtol = atol = 1e-5``.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch
from helpers.invariants import check_serving_invariants
from helpers.serving import ToyLM, make_engine, make_requests
from helpers.torch_port import fp32_config, model_pair
from helpers.torch_serving import (assert_engines_match, close_port_meshes,
                                   make_port_engine, port_mesh,
                                   port_requests, streams)
from helpers.torch_toy import TorchToyLM

import repro.kernels.paged_attention.ops as jax_pa
from repro.launch.mesh import make_serving_mesh as jax_mesh
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServerConfig as JaxServerConfig
from repro.runtime.serve_loop import ServingEngine as JaxEngine
from repro.core.sim import SimExecutor as JaxSim
from repro_torch.core.sim import SimExecutor
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_sharded)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (SERVING_AXIS, MeshError,
                                     make_serving_mesh, simulate_host_devices)
from repro_torch.runtime import Request, ServerConfig, ServingEngine

from test_kernels import _paged_brute_force

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _meshes():
    simulate_host_devices(4)
    yield
    close_port_meshes()


# ---------------------------------------------------------------------------
# simulated mesh plumbing
# ---------------------------------------------------------------------------

def test_simulated_device_split(monkeypatch):
    """4 host slots, as the reference's conftest splits 4 XLA devices; a
    count set before is respected, as the reference respects its flag."""
    assert mesh_mod.host_devices() == len(jax.devices()) == 4
    monkeypatch.setenv(mesh_mod.HOST_DEVICES_ENV, "2")
    simulate_host_devices(8)
    assert mesh_mod.host_devices() == 2


def test_make_serving_mesh_sizes_and_offsets():
    for n in (1, 2, 4):
        mesh, ref = make_serving_mesh(n), jax_mesh(n)
        assert mesh.size == ref.devices.size == n
        assert mesh.axis_names == ref.axis_names == (SERVING_AXIS,)
        assert mesh.backend == "gloo" and not mesh.processes
    a, b = make_serving_mesh(2, offset=0), make_serving_mesh(2, offset=2)
    assert not set(a.devices) & set(b.devices)
    for args, kw in (((4,), dict(offset=2)), ((0,), {})):
        with pytest.raises(ValueError) as ref_err:
            jax_mesh(*args, **kw)
        with pytest.raises(ValueError) as port_err:
            make_serving_mesh(*args, **kw)
        # the same message up to the remedy each package names
        assert str(port_err.value)[:30] == str(ref_err.value)[:30]
    two = make_serving_mesh(["cpu", "cpu"])
    assert two.devices == ("cpu:0", "cpu:0") and two.backend == "gloo"
    with pytest.raises(ValueError, match="at least 1"):
        make_serving_mesh([])


def test_workers_import_no_jax_and_close():
    """Every worker joined the group, holds no jax, and ends with its
    mesh."""
    mesh = make_serving_mesh(2, offset=2)
    info = mesh.probe()
    assert [p["rank"] for p in info] == [0, 1]
    assert all(p["size"] == 2 and p["backend"] == "gloo"
               and not p["jax_imported"] for p in info)
    procs = mesh.processes
    mesh.close()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    with pytest.raises(MeshError, match="closed"):
        mesh.probe()


def test_a_failing_worker_fails_the_call_and_ends_the_mesh():
    """A worker that raises reaches the controller as ``MeshError`` with
    its traceback, and no worker of the mesh is left running."""
    mesh = make_serving_mesh(2)
    with pytest.raises(MeshError, match="KeyError"):
        mesh.run("decode", None, -1, np.zeros(2, np.int32),
                 np.zeros((2, 1), np.int32), np.zeros(2, np.int32))
    assert mesh.closed
    assert all(not p.is_alive() for p in mesh.processes)


def test_workers_share_the_controllers_weights():
    """A rank's weights are views of the controller's, not copies: a write
    to the controller's weights after binding reaches every rank."""
    model = TorchToyLM(8, paged=True)
    sharded = port_mesh(2).bind(model)
    tok = np.asarray([3, 5], np.int32)
    table = np.asarray([[0], [1]], np.int32)
    pos = np.zeros(2, np.int32)

    def step():
        _, got = sharded.paged_decode_step(sharded.init_paged_state(2, 4),
                                           tok, table, pos)
        _, want = model.paged_decode_step(
            model.init_paged_state(2, 4),
            *(torch.from_numpy(a) for a in (tok, table, pos)))
        assert torch.equal(got, want)
        return want

    before = step()
    model.out.copy_(model.out.flip(1))
    assert not torch.equal(step(), before)


def test_toy_twin_weights_are_the_references():
    for d in (8, 4):
        ref = ToyLM(d).init()
        twin = TorchToyLM(d)
        assert np.array_equal(twin.emb.numpy(), np.asarray(ref["emb"]))
        assert np.array_equal(twin.out.numpy(), np.asarray(ref["out"]))
        assert dataclasses.asdict(twin.cfg) == dataclasses.asdict(ToyLM(d).cfg)


# ---------------------------------------------------------------------------
# tensor-parallel differential (ToyLM: byte-exact)
# ---------------------------------------------------------------------------

def _run_pair(mesh_devices, kv_mode, share, *, seed=5, n_requests=10):
    """The reference's and the port's engine on one workload: (ref engine,
    ref requests, port engine, port requests)."""
    kw = dict(seed=seed, kv_mode=kv_mode, prefix_sharing=share,
              prefix_cache_seqs=2 if share else 0,
              mesh_devices=mesh_devices)
    reqs = make_requests(random.Random(seed * 31 + 7), n_requests,
                         sample_prob=0.5,
                         share_prob=0.4 if share else 0.0)
    sides = []
    for make, convert in ((make_engine, list),
                          (make_port_engine, port_requests)):
        eng, _ = make(**kw)
        rs = convert(reqs)
        for r in rs:
            eng.submit(r)
        eng.drain(timeout=120)
        check_serving_invariants(
            eng, rs, ctx=f"mesh={mesh_devices} kv={kv_mode} share={share}")
        sides += [eng, rs]
    return tuple(sides)


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_mesh_streams_byte_identical(kv_mode, share):
    """1-, 2- and 4-rank streams == the no-mesh run's, and the whole run
    == the reference's mesh engine's, byte for byte."""
    _, _, eng0, base = _run_pair(0, kv_mode, share)
    assert eng0.tp_shards == 1 and eng0.mesh is None
    for n in (1, 2, 4):
        ref, ref_reqs, eng, reqs = _run_pair(n, kv_mode, share)
        assert streams(reqs) == streams(base), f"mesh={n} diverged"
        assert_engines_match(ref, eng, ref_reqs, reqs, ctx=f"mesh={n}")
        # dense mode has no page pool to shard: the mesh is ignored
        assert eng.tp_shards == ref.tp_shards == (
            n if kv_mode == "paged" else 1)
        assert eng.serving_stats()["tp_shards"] == eng.tp_shards
        assert (eng.mesh is None) == (ref.mesh is None)
        if eng.mesh is not None:
            # the workers built the twin's shards without importing jax
            assert not any(p["jax_imported"] for p in eng.mesh.probe())


def test_tp_fallback_when_heads_dont_divide():
    """d=8 on a 3-slot mesh: ``auto`` falls back to dense, explicit
    ``paged`` to an unsharded pool; both trace ``tp_fallback`` as the
    reference does and stream as the no-mesh run."""
    _, _, _, base = _run_pair(0, "auto", False)
    for kv_mode, resolved in (("auto", "dense"), ("paged", "paged")):
        ref, ref_reqs, eng, reqs = _run_pair(3, kv_mode, False)
        assert streams(reqs) == streams(base)
        assert_engines_match(ref, eng, ref_reqs, reqs, ctx=kv_mode)
        assert eng.kv_mode == resolved and eng.mesh is None
        assert eng.tp_shards == 1
        lines = [x for x in eng.trace() if "tp_fallback" in x]
        assert lines == [x for x in ref.trace() if "tp_fallback" in x]
        assert lines == [f"0.000000 tp_fallback kv_mode={resolved}"]
    # the 3-slot mesh was never started: nothing ran on it
    assert not port_mesh(3).processes


def test_arena_shard_stats():
    stats = []
    for make, convert in ((make_engine, list),
                          (make_port_engine, port_requests)):
        eng, _ = make(seed=2, kv_mode="paged", mesh_devices=2)
        for r in convert(make_requests(random.Random(9), 4)):
            eng.submit(r)
        eng.drain(timeout=60)
        stats.append(eng.kv.shard_stats())
        assert stats[-1]["page_bytes_per_shard"] * 2 == \
            eng.kv.arena.page_bytes
    assert stats[1] == stats[0]
    assert stats[1]["tp_shards"] == 2
    assert stats[1]["live_pages_per_shard"] == 0


# ---------------------------------------------------------------------------
# kernel parity under sharding
# ---------------------------------------------------------------------------

def _case(seed, B, K, G, hd, page, P, lens):
    """Seeded q/pages and a -1-padded table over a permutation of pages."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    q = rng.standard_normal((B, K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    width = max(-(-int(n) // page) for n in lens)
    table = np.full((B, width), -1, np.int32)
    pool = list(rng.permutation(P))
    for b in range(B):
        for i in range(-(-int(lens[b]) // page)):
            table[b, i] = pool.pop()
    return q, kp, vp, table, lens


def _port(q, kp, vp, table, lens, mesh):
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    if mesh is False:
        return paged_attention(*args, table, lens, scale=0.25)
    return paged_attention_sharded(*args, table, lens, scale=0.25,
                                   mesh=mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_paged_attention_sharded_bit_exact(n):
    """Head-sharded == unsharded, bit for bit; within 2e-5 of the
    reference's sharded kernel and 1e-4 of the brute-force oracle."""
    q, kp, vp, table, lens = _case(n, 3, 4, 2, 16, page=8, P=24,
                                   lens=[5, 17, 40])
    mesh = port_mesh(n)
    out = _port(q, kp, vp, table, lens, mesh)
    assert torch.equal(out, _port(q, kp, vp, table, lens, False))
    ref = jax_pa.paged_attention_sharded(
        q, kp, vp, table, lens, scale=0.25, mesh=jax_mesh(n),
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        out.numpy(), _paged_brute_force(q, kp, vp, table, lens, 0.25),
        rtol=1e-4, atol=1e-4)


def test_paged_attention_sharded_dead_rows():
    """A dead slot (len 0, all--1 row) is exactly zero on every shard, and
    live rows ignore trailing -1 padding."""
    q, kp, vp, table, lens = _case(7, 3, 2, 2, 16, page=8, P=16,
                                   lens=[11, 5, 16])
    lens[1] = 0
    table[1, :] = -1
    wide = np.pad(table, ((0, 0), (0, 5)), constant_values=-1)
    out = _port(q, kp, vp, wide, lens, port_mesh(2)).numpy()
    assert np.all(np.isfinite(out)) and np.all(out[1] == 0.0)
    ref = np.asarray(jax_pa.paged_attention_sharded(
        q, kp, vp, wide, lens, scale=0.25, mesh=jax_mesh(2),
        interpret=True), np.float32)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    brute = _paged_brute_force(q, kp, vp, table, lens, 0.25)
    np.testing.assert_allclose(out[[0, 2]], brute[[0, 2]], rtol=1e-4,
                               atol=1e-4)


def test_paged_attention_sharded_fallback_non_divisible():
    """K=3 kv heads on 2 ranks cannot split a head group: the unsharded
    call, on no worker (the mesh is never started)."""
    q, kp, vp, table, lens = _case(9, 2, 3, 2, 16, page=8, P=16,
                                   lens=[9, 20])
    mesh = make_serving_mesh(2)
    base = _port(q, kp, vp, table, lens, False)
    assert torch.equal(_port(q, kp, vp, table, lens, mesh), base)
    assert torch.equal(_port(q, kp, vp, table, lens, None), base)
    assert not mesh.processes


# ---------------------------------------------------------------------------
# transformer under TP (decode step + engine smoke)
# ---------------------------------------------------------------------------

_TP_MODEL = {}


def _tp_transformer():
    """The reference's reduced qwen2.5 reshaped to 4 kv heads (TP-4 is
    legal), with its weights converted to the port."""
    if not _TP_MODEL:
        cfg = fp32_config("qwen2.5-32b", num_heads=4, num_kv_heads=4,
                          head_dim=16)
        _TP_MODEL["pair"] = model_pair(cfg)
    return _TP_MODEL["pair"]


def test_tp_param_specs_match_the_references():
    jm, params, tm = _tp_transformer()
    ref = jax.tree_util.tree_flatten_with_path(
        jm.tp_param_specs(params),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    ref = {".".join(k.key for k in path): tuple(spec) for path, spec in ref}
    port = {name: tuple(spec) for name, spec in tm.tp_param_specs().items()}
    assert port == ref
    store = tm.init_paged_state(4, 4)
    assert {k: tuple(v) for k, v in tm.tp_pool_specs(store).items()} == {
        k: tuple(v) for k, v in jm.tp_pool_specs(store).items()}
    for n in (1, 2, 4):
        assert tm.tp_supported(n) == jm.tp_supported(n)
    assert not tm.tp_supported(3)


@pytest.mark.parametrize("n", [2, 4])
def test_transformer_decode_step_sharded(n):
    """The port's paged decode step on n ranks against its unsharded step
    and the reference's ``shard_map``'d step, on the same pool: logits and
    both page pools within ``TOL`` (fp32)."""
    from jax.sharding import PartitionSpec as JP

    from repro.compat import shard_map
    from repro.parallel.sharding import serving_tp_shardings

    jm, params, tm = _tp_transformer()
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (1, 6)).astype(np.int32)
    page_ids = np.asarray([0, 0, 0, 0, 1, 1])
    offsets = np.asarray([0, 1, 2, 3, 0, 1])
    table = np.asarray([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    pos = np.asarray([6, 0], np.int32)
    tok = np.asarray([5, 7], np.int32)

    # the reference: prefill, scatter, then the shard_map'd step
    store = jm.init_paged_state(16, 4)
    rows, _ = jm.paged_prefill(params, jax.numpy.asarray(toks))
    store = jm.paged_write_prefill(store, rows, page_ids, offsets)
    mesh = jax_mesh(n)
    pspecs, poolspecs = jm.tp_param_specs(params), jm.tp_pool_specs(store)
    fn = jax.jit(shard_map(
        jm.paged_decode_step, mesh,
        in_specs=(pspecs, poolspecs, JP(), JP(), JP()),
        out_specs=(poolspecs, JP()), check_vma=False))
    ref_pool, ref_logits = fn(
        jax.device_put(params, serving_tp_shardings(mesh, pspecs)),
        jax.device_put(store, serving_tp_shardings(mesh, poolspecs)),
        tok, table, pos)

    # the port, unsharded and on the mesh
    pool = tm.init_paged_state(16, 4)
    rows, _ = tm.paged_prefill(torch.from_numpy(toks))
    tm.paged_write_prefill(pool, rows, page_ids, offsets)
    base_pool, base_logits = tm.paged_decode_step(
        pool, *(torch.from_numpy(a) for a in (tok, table, pos)))

    sharded = port_mesh(n).bind(tm)
    handle = sharded.init_paged_state(16, 4)
    rows, _ = sharded.paged_prefill(toks)
    sharded.paged_write_prefill(handle, rows, page_ids, offsets)
    _, logits = sharded.paged_decode_step(handle, tok, table, pos)
    sh_pool = sharded.gather_pool(handle)

    np.testing.assert_allclose(logits.numpy(), base_logits.numpy(), **TOL)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(ref_logits, np.float32), **TOL)
    for k in ("k_pages", "v_pages"):
        np.testing.assert_allclose(sh_pool[k].numpy(),
                                   base_pool[k].numpy(), **TOL)
        np.testing.assert_allclose(sh_pool[k].numpy(),
                                   np.asarray(ref_pool[k], np.float32),
                                   **TOL)


def _smoke_requests(vocab, convert):
    rng = random.Random(21)
    out = []
    for i in range(4):
        prompt = np.asarray([rng.randrange(vocab) for _ in range(4)],
                            np.int32)
        out.append(convert(prompt=prompt, max_new_tokens=4, request_id=i,
                           tenant="t", seed=rng.randrange(1 << 31)))
    return out


def test_transformer_sharded_engine_smoke():
    """A real transformer serves paged TP-4: requests complete, the plane
    drains clean, ``tp_shards`` reports the width, and the greedy streams
    equal the port's no-mesh engine's and the reference's TP-4 engine's."""
    jm, params, tm = _tp_transformer()
    cfg = dict(max_batch=2, max_seq=32, tokens_per_page=4,
               step_time_s=0.01, kv_mode="paged", prefix_sharing=True)
    ref = JaxEngine(jm, params, JaxServerConfig(**cfg),
                    executor=JaxSim(seed=4), mesh=jax_mesh(4))
    ref_reqs = _smoke_requests(tm.cfg.vocab_size, JaxRequest)
    runs = []
    for mesh in (port_mesh(4), None):
        eng = ServingEngine(tm, ServerConfig(**cfg),
                            executor=SimExecutor(seed=4), mesh=mesh)
        reqs = _smoke_requests(tm.cfg.vocab_size, Request)
        for r in reqs:
            eng.submit(r)
        eng.drain(timeout=300)
        check_serving_invariants(eng, reqs, ctx=f"mesh={mesh}")
        assert all(r.error is None and len(r.tokens) == 4 for r in reqs)
        runs.append((eng, reqs))
    for r in ref_reqs:
        ref.submit(r)
    ref.drain(timeout=300)
    (eng, reqs), (_, plain) = runs
    assert eng.kv_mode == "paged" and eng.tp_shards == ref.tp_shards == 4
    assert streams(reqs) == streams(plain)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]


def test_transformer_auto_falls_back_to_dense():
    """Stock reduced qwen2.5 has 1 kv head: on 4 ranks ``auto`` serves
    dense rather than mis-shard, with the reference's trace line."""
    jm, params, tm = model_pair(fp32_config("qwen2.5-32b"))
    assert tm.supports_paged_decode and not tm.tp_supported(4)
    cfg = dict(max_batch=2, max_seq=32, tokens_per_page=4,
               step_time_s=0.01, kv_mode="auto")
    eng = ServingEngine(tm, ServerConfig(**cfg), executor=SimExecutor(seed=4),
                        mesh=port_mesh(4))
    ref = JaxEngine(jm, params, JaxServerConfig(**cfg),
                    executor=JaxSim(seed=4), mesh=jax_mesh(4))
    assert eng.kv_mode == ref.kv_mode == "dense"
    assert eng.mesh is None and eng.tp_shards == 1
    assert eng.trace() == ref.trace() == ["0.000000 tp_fallback kv_mode=dense"]
