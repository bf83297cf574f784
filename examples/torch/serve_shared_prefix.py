"""Cross-tenant prefix sharing on the PyTorch port: two tenants, one
system prompt.

The twin of ``examples/serve_shared_prefix.py``, over ``repro_torch``.
Both tenants' requests open with the same 24-token system prompt.  With
``ServerConfig.prefix_sharing`` (on by default in paged mode) the first
request prefills the header once; every later request maps those K/V
pages read-only out of the arena's radix index and prefills only its own
suffix.  The first divergent write copy-on-writes the shared partial
page, and the streams equal a run with sharing disabled.

    PYTHONPATH=src python examples/torch/serve_shared_prefix.py
    PYTHONPATH=src python examples/torch/serve_shared_prefix.py --reduced --device cpu

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


def make_requests(vocab):
    rng = np.random.default_rng(42)
    system_prompt = rng.integers(0, vocab, (24,))    # shared by everyone
    reqs = []
    for i in range(8):
        user_turn = rng.integers(0, vocab, (8,))     # per-request suffix
        reqs.append(Request(
            prompt=np.concatenate([system_prompt, user_turn]).astype(np.int32),
            max_new_tokens=6, request_id=i,
            tenant=("alice", "bob")[i % 2],          # cross-tenant!
        ))
    return reqs


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    cfg = get_reduced("qwen2.5-32b") if args.reduced else \
        dataclasses.replace(get_config("qwen2.5-32b"), num_layers=2)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(model.device).manual_seed(0))

    streams = {}
    for sharing in (True, False):
        srv = Server(model, ServerConfig(
            max_batch=2, max_seq=64,
            prefix_sharing=sharing,
            # keep up to 2 retired donors resident (the warm prefix
            # cache), so sharing works across waves and idle gaps
            prefix_cache_seqs=2,
        ))
        done = srv.run(make_requests(cfg.vocab_size))
        stats = srv.engine.serving_stats()
        name = "shared" if sharing else "unshared"
        print(f"[{name}] {len(done)} requests, 2 tenants, one 24-token "
              f"system prompt ({cfg.arch_id} on {model.device})")
        print(f"  prefix hits       : {stats['prefix_hits_total']}")
        print(f"  pages shared      : {stats['prefix_shared_pages_total']}")
        print(f"  tokens saved      : "
              f"{stats['prefix_prefill_tokens_saved_total']} "
              f"(of {sum(len(r.prompt) for r in done)} prompt tokens)")
        print(f"  COW copies        : {stats['prefix_cow_copies_total']}")
        print(f"  prefill tokens    : "
              f"{stats['prefill_tokens_total']['incremental']}")
        srv.engine.flush_prefix_cache()              # release parked donors
        assert srv.kv.pages_allocated == srv.kv.pages_freed
        streams[sharing] = {r.request_id: tuple(r.tokens) for r in done}
        srv.close()

    print("streams identical with and without sharing:",
          streams[True] == streams[False])


if __name__ == "__main__":
    main()
