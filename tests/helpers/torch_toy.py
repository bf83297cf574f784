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
"""

import numpy as np
import torch
from helpers.serving import ToyLM

__all__ = ["TorchToyLM"]


class TorchToyLM:
    MASK = ToyLM.MASK

    def __init__(self, d: int = 8, device="cpu", *, paged: bool = False) -> None:
        ref = ToyLM(d)
        self.cfg = ref.cfg
        self.d = d
        self.device = torch.device(device)
        self.supports_paged_decode = paged
        params = ref.init()
        self.emb = torch.from_numpy(np.array(params["emb"])).to(self.device)
        self.out = torch.from_numpy(
            np.array(params["out"], np.int64)).to(self.device)

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
        return (h.long()[:, :, None] * self.out[None]).sum(dim=1)

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
