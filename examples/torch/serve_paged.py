"""End-to-end serving on the PyTorch port: continuous batching over the
SEE++ paged KV arena.

The twin of ``examples/serve_paged.py``, over ``repro_torch``: the
arena's page pool is the physical KV store, decode attention runs
through the hand-written paged-attention kernel on the card (its plain
version on the CPU), sampled streams are reproducible by seed, with the
legacy-vs-modern allocator A/B, a sandboxed user post-processor and a
mid-flight batch kill (in paged mode recovery is a page-table edit:
sequences resume off their surviving pages with no re-prefill).

    PYTHONPATH=src python examples/torch/serve_paged.py
    PYTHONPATH=src python examples/torch/serve_paged.py --reduced --device cpu

On the card by default: qwen2.5-32b at its published widths, 2 of 64
layers; ``--reduced`` takes its reduced config.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model
from repro_torch.runtime import Request, Server, ServerConfig


def dedupe(tokens):                         # user code, runs in the Sentry
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=tokens.device),
                      tokens[1:] != tokens[:-1]])
    return torch.where(keep, tokens, -1)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    cfg = get_reduced("qwen2.5-32b") if args.reduced else \
        dataclasses.replace(get_config("qwen2.5-32b"), num_layers=2)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(model.device).manual_seed(0))

    def make_requests():
        r = np.random.default_rng(7)
        return [
            Request(prompt=r.integers(0, cfg.vocab_size, (6,)).astype(np.int32),
                    max_new_tokens=8, request_id=i,
                    temperature=0.8 if i % 2 else 0.0, top_k=8, seed=100 + i,
                    postprocess=dedupe if i == 0 else None)
            for i in range(6)
        ]

    # -- legacy-vs-modern allocator A/B over the paged decode plane -----
    for legacy in (True, False):
        srv = Server(model, ServerConfig(max_batch=4, max_seq=96,
                                         mm_legacy=legacy))
        done = srv.run(make_requests())
        stats = srv.arena_report()["mm_stats"]
        name = "legacy" if legacy else "modern"
        print(f"[{name}] {len(done)} requests served "
              f"(kv_mode={srv.engine.kv_mode}, {cfg.arch_id} on "
              f"{model.device}); host VMAs hw={stats['host_vma_high_water']} "
              f"faults={stats['faults']}")
        srv.close()
    baseline = {r.request_id: tuple(r.tokens)
                for r in sorted(done, key=lambda r: r.request_id)}
    print("first request postprocessed (sandboxed):",
          sorted(done, key=lambda r: r.request_id)[0].tokens)

    # -- eviction is a table edit: kill the batch mid-flight ------------
    srv = Server(model, ServerConfig(max_batch=4, max_seq=96))
    reqs = make_requests()
    for r in reqs:
        srv.submit(r)
    srv.step()                              # everything admitted + decoding
    srv.engine.kill_batch()                 # chaos: evict every live slot
    srv.drain()
    stats = srv.engine.serving_stats()
    resumed = {r.request_id: tuple(r.tokens)
               for r in sorted(reqs, key=lambda r: r.request_id)}
    print(f"[kill] batch killed mid-flight: evicted={stats['evicted_total']} "
          f"resumed={stats['resumed_total']} off surviving pages "
          f"(pages allocated={stats['kv_pages_allocated_total']} "
          f"freed={stats['kv_pages_freed_total']})")
    print("[kill] seeded streams identical to the un-killed run:",
          resumed == baseline)
    srv.close()


if __name__ == "__main__":
    main()
