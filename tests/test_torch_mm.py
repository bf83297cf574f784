"""The port's memory manager (``core/mm.py``) against the reference's.

Seeded random programs of ``mmap`` / ``touch`` / ``munmap`` run through
both managers, under the legacy and the modern configuration and at two
granules; after every operation the host view, its count and high-water
mark, the stats, the fault log and the backing free list must be equal,
and the port's kept count must equal a fresh coalescing of its own
mappings.  With the map-count limit enforced, both must crash at the same
operation.

Then the paged engine over the torch twin of ``ToyLM``, with prefix
sharing on so that zombie regions occur: after every ``step()`` the
arena's reported host-VMA count is the coalesced one, while ``step()``
itself never coalesces.
"""

import numpy as np
import pytest
from helpers.torch_serving import make_port_engine

from repro.core import mm as ref_mm
from repro_torch.core import mm
from repro_torch.core.vma import AddrRange, VMAExhaustedError
from repro_torch.runtime import Request

CONFIGS = {"legacy": mm.MMConfig.legacy, "modern": mm.MMConfig.modern}
REF_CONFIGS = {"legacy": ref_mm.MMConfig.legacy,
               "modern": ref_mm.MMConfig.modern}
OPS = 160


def _view(manager):
    """Everything observable of one manager, in plain values."""
    return {
        "host_vmas": [(h.addr.start, h.addr.end, h.offset, h.flags)
                      for h in manager.host_vmas()],
        "high_water": manager.host_vma_high_water,
        "stats": manager.stats(),
        "fault_log": [(f.addr, f.length, f.offset, f.direction.value,
                       f.hinted) for f in manager.fault_log],
        "free": list(manager.backing._free),
        "allocated": manager.backing.allocated_bytes,
        "sentry": [(v.start, v.end, v.flags, v.last_fault)
                   for v in manager.vmas],
    }


def _outcome(fn):
    """None, or the message of the map-count crash ``fn`` raised."""
    try:
        fn()
    except (VMAExhaustedError, ref_mm.VMAExhaustedError) as e:
        return str(e)
    return None


def _op(rng, n_ranges, max_ranges=6):
    """One random operation over the live address ranges: ("mmap",
    granules, flags) | ("touch", slot, u, v) | ("munmap", slot, whole, u, v),
    with ``slot`` indexing the live ranges and u, v in [0, 1) placing the
    touch or the slice to unmap inside that range."""
    kind = rng.choice(["mmap", "touch", "touch", "touch", "munmap"])
    if n_ranges == 0 or (kind == "mmap" and n_ranges < max_ranges):
        return ("mmap", int(rng.integers(1, 48)), int(rng.integers(0, 2)))
    slot = int(rng.integers(0, n_ranges))
    if kind == "touch":
        # a whole range in one fault now and then, so that neighbouring
        # ranges end up offset-contiguous
        if rng.random() < 0.3:
            return ("touch", slot, 0.0, 1.0)
        return ("touch", slot, rng.random(), rng.random())
    # whole ranges mostly; sometimes a slice, which splits one
    return ("munmap", slot, rng.random() < 0.7, rng.random(), rng.random())


def _run(port, ref, g, op, ranges):
    """Apply ``op`` to both managers; returns both outcomes."""
    kind = op[0]
    if kind == "mmap":
        _, n, flags = op
        a = port.mmap(n * g, flags)
        b = ref.mmap(n * g, flags)
        assert (a.start, a.end) == (b.start, b.end)
        ranges.append((a.start, a.end))
        return None, None
    start, end = ranges[op[1]]
    if kind == "touch":
        _, _, u, v = op
        # any byte in the range, up to its end: partial touches leave
        # unfaulted granules and unaligned edges
        addr = start + int(u * (end - start - 1))
        length = 1 + int(v * (end - addr - 1))
        return (_outcome(lambda: port.touch(addr, length)),
                _outcome(lambda: ref.touch(addr, length)))
    _, _, whole, u, v = op
    ranges.pop(op[1])
    n = (end - start) // g
    if whole or n < 2:
        lo, hi = 0, n
    else:
        lo = int(u * (n - 1))
        hi = lo + 1 + int(v * (n - lo - 1))
        if lo:
            ranges.append((start, start + lo * g))
        if hi < n:
            ranges.append((start + hi * g, end))
    port.munmap(AddrRange(start + lo * g, start + hi * g))
    ref.munmap(ref_mm.AddrRange(start + lo * g, start + hi * g))
    return None, None


CASES = [
    pytest.param(cfg, g, enforce, seed,
                 id=f"{cfg}-g{g}-{'enforce' if enforce else 'free'}-{seed}")
    for cfg in sorted(CONFIGS)
    for g in (4096, 65536)
    for enforce in (False, True)
    for seed in range(4)
]


@pytest.mark.parametrize("cfg,granule,enforce,seed", CASES)
def test_memory_manager_matches_reference(cfg, granule, enforce, seed):
    kw = dict(granule=granule, enforce_map_count=enforce,
              max_map_count=6 if enforce else mm.MMConfig.max_map_count)
    port = mm.MemoryManager(CONFIGS[cfg](**kw))
    ref = ref_mm.MemoryManager(REF_CONFIGS[cfg](**kw))
    rng = np.random.default_rng(1000 * seed + granule % 997)
    ranges, crashes = [], 0
    for i in range(OPS):
        op = _op(rng, len(ranges))
        got, want = _run(port, ref, granule, op, ranges)
        assert got == want, f"op {i} {op}: {got} != {want}"
        crashes += got is not None
        # the high-water mark before this check's own sample
        assert port.host_vma_high_water == ref.host_vma_high_water, i
        count = port.host_vma_count()
        assert count == ref.host_vma_count(), f"op {i} {op}"
        assert count == len(mm.coalesce_host_mappings(
            list(port._mappings.values()))), f"op {i} {op}"
        assert _view(port) == _view(ref), f"op {i} {op}"
    if enforce:
        assert crashes, "the enforced limit was never reached"
    for start, end in ranges:
        port.munmap(AddrRange(start, end))
        ref.munmap(ref_mm.AddrRange(start, end))
    assert port._mappings == {} and port.host_vma_count() == 0
    assert _view(port) == _view(ref)


def _engine_requests():
    """Per round: a donor on a fresh 8-token head, a one-token filler, then
    a sharer of the donor's head that outlives it, so the donor's region
    turns zombie while the sharer still maps its pages."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(2):
        head = rng.integers(0, 31, 8)
        for j, new in enumerate((3, 1, 9)):
            body = rng.integers(0, 31, 3 + j)
            prompt = body if j == 1 else np.concatenate([head, body])
            out.append(Request(prompt=prompt.astype(np.int32),
                               max_new_tokens=new, request_id=3 * i + j))
    return out


@pytest.mark.parametrize("chunk", [0, 5], ids=["paged", "chunked-paged"])
def test_engine_steps_keep_host_vma_count_without_walking(monkeypatch,
                                                          chunk):
    calls = []
    walk = mm.coalesce_host_mappings
    monkeypatch.setattr(mm, "coalesce_host_mappings",
                        lambda ms: calls.append(len(ms)) or walk(ms))
    engine, _ = make_port_engine(0, step_time_s=0.0, max_batch=2,
                                 kv_mode="paged", prefix_sharing=True,
                                 prefill_chunk_tokens=chunk)
    reqs = _engine_requests()
    for r in reqs:
        engine.submit(r)
    arena = engine.kv.arena
    zombies = steps = 0
    while engine.has_work():
        before = len(calls)
        engine.step()
        steps += 1
        assert len(calls) == before, "step() walked the mappings"
        zombies += bool(engine.kv.zombie_regions())
        assert engine.arena_report()["host_vmas"] == len(arena.mm.host_vmas())
    assert zombies, "no zombie region occurred"
    assert len(calls) == steps
    assert all(r.error is None and len(r.tokens) == r.max_new_tokens
               for r in reqs)
    assert arena.mm._mappings == {}
    assert arena.mm.host_vma_count() == 0
    assert engine.arena_report()["host_vma_high_water"] > 0
