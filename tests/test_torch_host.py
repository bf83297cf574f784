"""Port parity: the host substrate (arena, sampler) against the reference.

The same seeded operation sequence drives the reference's and the port's
``PagedKVAllocator`` (alloc, prefix share, COW, drop, poison, park), and
every observable after every operation must be equal.  The port's
sampler must draw the same token over a seeded grid of logits and knobs.
"""

import numpy as np
import pytest

from repro.core import arena as ref_arena
from repro.core import mm as ref_mm
from repro.runtime.sampling import sample_token as ref_sample
from repro_torch.core import arena as port_arena
from repro_torch.core import mm as port_mm
from repro_torch.runtime.sampling import sample_token as port_sample

PAGE = 4


def _drive(arena_mod, mm_mod, seed: int, legacy: bool):
    """Apply a seeded op sequence; return the log of every observable."""
    mm_cfg = (mm_mod.MMConfig.legacy if legacy else mm_mod.MMConfig.modern)(
        granule=4096)
    kv = arena_mod.PagedKVAllocator(
        mm_cfg, tokens_per_page=PAGE, token_bytes=64, max_seq_pages=16,
        pool_pages=96)
    rng = np.random.default_rng(seed)
    prompts = {}
    log = []
    n = 0
    for _ in range(60):
        op = int(rng.integers(0, 7))
        live = sorted(prompts)
        if op <= 1 or not live:                       # new sequence
            base = prompts[live[int(rng.integers(len(live)))]] \
                if live and op == 1 else []
            keep = int(rng.integers(0, len(base) + 1))
            toks = list(base[:keep]) + [
                int(t) for t in rng.integers(0, 5, int(rng.integers(1, 12)))]
            sid = f"s{n}"
            n += 1
            kv.add_sequence(sid)
            donor, match = kv.lookup_prefix(toks)
            match = min(match, len(toks) - 1)
            start = 0
            if donor is not None and match >= PAGE:
                kv.share_prefix(sid, donor, match)
                start = match
            kv.append_tokens(sid, len(toks) - start)
            for lp in range(start // PAGE, -(-len(toks) // PAGE)):
                if not kv.page_writable(sid, lp):
                    log.append(("cow", sid, kv.cow_page(sid, lp)))
            kv.register_prefix(sid, toks)
            prompts[sid] = toks
            log.append(("add", sid, donor, start))
        elif op == 2:                                 # decode growth + COW
            sid = live[int(rng.integers(len(live)))]
            grow = kv.resident_tokens(sid) + int(rng.integers(1, 6))
            kv.ensure_tokens(sid, grow)
            lp = (grow - 1) // PAGE
            if not kv.page_writable(sid, lp):
                log.append(("cow", sid, kv.cow_page(sid, lp)))
        elif op == 3:                                 # retire
            sid = live[int(rng.integers(len(live)))]
            kv.drop_sequence(sid)
            del prompts[sid]
        elif op == 4:                                 # poison + evict
            sid = live[int(rng.integers(len(live)))]
            kv.poison_sequence(sid)
            for bad in kv.validate():
                kv.drop_sequence(bad)
                prompts.pop(bad, None)
        elif op == 5:                                 # park a donor
            sid = live[int(rng.integers(len(live)))]
            kv.rename_sequence(sid, f"~pfx{n}")
            prompts[f"~pfx{n}"] = prompts.pop(sid)
            n += 1
        else:
            sid = live[int(rng.integers(len(live)))]
            log.append(("shared", sid, kv.sequence_shared(sid)))
        ids = sorted(prompts)
        log.append((
            kv.page_table(seq_ids=ids).tolist(), kv.seq_lens(ids).tolist(),
            [tuple(a.tolist() for a in kv.token_positions(
                s, 0, kv.resident_tokens(s))) for s in ids],
            kv.pages_allocated, kv.pages_freed, kv.shared_pages_total,
            kv.cow_copies_total, kv.validate(), kv.live_pages(),
            kv.zombie_regions(), kv.arena.mm.stats(),
        ))
    for sid in sorted(prompts):
        kv.drop_sequence(sid)
    log.append((kv.pages_allocated, kv.pages_freed, kv.live_pages()))
    return log


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_arena_sequence_matches_reference(seed, legacy):
    ref = _drive(ref_arena, ref_mm, seed, legacy)
    port = _drive(port_arena, port_mm, seed, legacy)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"op {i} diverged"
    assert port[-1][0] == port[-1][1] and port[-1][2] == 0


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 0, 1.0), (0.8, 5, 1.0),
    (0.8, 50, 1.0), (1.0, 0, 0.9), (0.5, 0, 0.5), (1.0, 8, 0.8),
])
def test_sample_token_matches_reference(temperature, top_k, top_p):
    rng = np.random.default_rng(11)
    for index in range(40):
        row = rng.standard_normal(64).astype(np.float32)
        if index % 7 == 0:
            row[3] = row[9] = row.max() + 1.0          # exact tie
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  seed=1234 + index, index=index)
        assert port_sample(row, **kw) == ref_sample(row, **kw)
