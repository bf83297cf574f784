"""A torch twin of the reference's integer ``ToyLM`` (``helpers/serving.py``).

The same recurrence over int32 state, ``h' = (5 h + emb[token]) & MASK``,
the same fixed weights, and the serving interfaces the port's engine
consumes: dense (``init_decode_state``, ``prefill``, ``decode_step``,
``prefill_chunk``) and paged (``init_paged_state``, ``paged_prefill``,
``paged_write_prefill``, ``paged_prefill_at``, ``paged_copy_page``,
``paged_decode_step``; the pool stores the state after each consumed
token, as the reference's does).  ``paged=False`` (the default) hides the
paged interface from ``kv_mode="auto"`` (``supports_paged_decode`` is
False), so the engine serves the twin dense; ``paged=True`` resolves like
the reference's ``ToyLM``.  The logits are an int64 sum of products:
exact, and equal to the reference's int32 ``h @ out`` (which never
overflows), so the port's engine must replay the reference engine's token
streams byte for byte.

Tensor-parallel serving, as the reference's ``ToyLM``: the recurrence is
elementwise in ``d``, so TP splits ``d`` (``emb`` and ``out`` on it, the
pool's rows on their last axis), and the only cross-shard operation is the
integer, hence exact, logits sum (``maybe_psum`` in ``_logits``).  A serving
mesh's workers build this class, so the module imports no jax: the
weights are the reference's formula, held equal to its ``init()`` by
``tests/test_torch_sharded_serving.py``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.parallel.collectives import maybe_psum
from repro_torch.parallel.sharding import P

__all__ = ["TorchToyLM", "toy_weights"]


@dataclass(frozen=True)
class _ToyCfg:
    vocab_size: int = 31
    num_kv_heads: int = 1
    hd: int = 4


def toy_weights(d: int, vocab: int = 31):
    """(emb (V, d) int32, out (d, V) int64): the reference's fixed
    weights, no RNG."""
    emb = (np.arange(vocab * d, dtype=np.int64).reshape(vocab, d)
           * 2654435761) & 0x7FFF
    out = (np.arange(d * vocab, dtype=np.int64).reshape(d, vocab)
           * 40503) & 0x7
    return emb.astype(np.int32), out


class TorchToyLM:
    MASK = 0x7FFFFF                        # 23-bit state: h @ out fits int32

    def __init__(self, d: int = 8, device="cpu", *, paged: bool = False) -> None:
        self.cfg = _ToyCfg()
        self.d = d
        self.device = torch.device(device)
        self.supports_paged_decode = paged
        emb, out = toy_weights(d, self.cfg.vocab_size)
        self.emb = torch.from_numpy(emb).to(self.device)
        self.out = torch.from_numpy(out).to(self.device)

    def named_parameters(self):
        return iter([("emb", self.emb), ("out", self.out)])

    def init_decode_state(self, batch_size: int, max_seq: int, dtype=None,
                          device=None):
        dev = self.device if device is None else device
        return {
            "h": torch.zeros((batch_size, self.d), dtype=torch.int32,
                             device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }

    def _advance(self, h, tokens):
        return (5 * h + self.emb[tokens.long()]) & self.MASK

    def _logits(self, h):
        return maybe_psum((h.long()[:, :, None] * self.out[None]).sum(dim=1))

    def _scan(self, h, tokens):
        """(final state, the state after each token (B, S, d))."""
        hs = []
        for t in range(tokens.shape[1]):
            h = self._advance(h, tokens[:, t])
            hs.append(h)
        return h, torch.stack(hs, dim=1)

    def _zeros(self, B):
        return torch.zeros((B, self.d), dtype=torch.int32, device=self.device)

    def prefill(self, tokens, *, max_seq=None):
        B, S = tokens.shape
        h, _ = self._scan(self._zeros(B), tokens)
        state = {"h": h, "pos": torch.full((B,), S, dtype=torch.int32,
                                           device=tokens.device)}
        return state, self._logits(h)

    def decode_step(self, state, tokens):
        h = self._advance(state["h"], tokens)
        return {"h": h, "pos": state["pos"] + 1}, self._logits(h)

    def prefill_chunk(self, tokens, state, start):
        """Fold the chunk into the carry; ``start == 0`` restarts from 0."""
        B, S = tokens.shape
        start = int(start)
        h0 = state["h"] if start > 0 else self._zeros(B)
        h, _ = self._scan(h0, tokens)
        return ({"h": h, "pos": torch.full_like(state["pos"], start + S)},
                self._logits(h))

    # -------------------------------------------- paged-decode interface

    def init_paged_state(self, num_pages: int, page_size: int, dtype=None):
        return {"h_pages": torch.zeros((num_pages, page_size, self.d),
                                       dtype=torch.int32, device=self.device)}

    def paged_prefill(self, tokens):
        h, hs = self._scan(self._zeros(tokens.shape[0]), tokens)
        return {"h": hs}, self._logits(h)

    def paged_write_prefill(self, pool, rows, page_ids, offsets):
        page_ids = torch.as_tensor(page_ids, device=self.device).long()
        offsets = torch.as_tensor(offsets, device=self.device).long()
        pool["h_pages"][page_ids, offsets] = rows["h"][0]
        return pool

    def paged_prefill_at(self, tokens, pool, page_table, start):
        """Resume the recurrence at the state row the donor wrote for
        token ``start - 1``."""
        B = tokens.shape[0]
        page = pool["h_pages"].shape[1]
        width = page_table.shape[1]
        start = int(start)
        prev = max(start - 1, 0)
        prev_page = max(int(page_table[0, min(prev // page, width - 1)]), 0)
        h0 = (pool["h_pages"][prev_page, prev % page] if start > 0
              else self._zeros(1)[0])
        h, hs = self._scan(h0.expand(B, self.d).clone(), tokens)
        return {"h": hs}, self._logits(h)

    def paged_copy_page(self, pool, src, dst):
        pool["h_pages"][int(dst)] = pool["h_pages"][int(src)]
        return pool

    def paged_decode_step(self, pool, tokens, page_table, pos):
        page = pool["h_pages"].shape[1]
        width = page_table.shape[1]
        b = torch.arange(tokens.shape[0], device=self.device)
        pos = pos.long()
        prev = (pos - 1).clamp(min=0)
        prev_page = page_table[b, (prev // page).clamp(max=width - 1)]
        h = self._advance(
            pool["h_pages"][prev_page.long().clamp(min=0), prev % page],
            tokens)
        logical = pos // page
        write_page = page_table[b, logical.clamp(max=width - 1)].long()
        # dead slots (all--1 rows) write nothing, as the reference's
        # out-of-bounds scatter is dropped
        live = (write_page >= 0) & (logical < width)
        pool["h_pages"][write_page[live], (pos % page)[live]] = h[live]
        return pool, self._logits(h)

    # ------------------------------------------- tensor-parallel serving

    def tp_supported(self, n: int) -> bool:
        return n >= 1 and self.d % n == 0

    def tp_param_specs(self):
        return {"emb": P(None, "model"), "out": P("model", None)}

    def tp_pool_specs(self, store):
        return {"h_pages": P(None, None, "model")}

    def tp_local(self, n: int):
        return TorchToyLM, {"d": self.d // n, "paged": True}
