"""A torch twin of the reference's integer ``ToyLM`` (``helpers/serving.py``).

The same recurrence over int32 state, ``h' = (5 h + emb[token]) & MASK``,
the same fixed weights, and the dense serving interface the port's engine
consumes (``cfg``, ``device``, ``init_decode_state``, ``prefill``,
``decode_step``).  It has no paged interface (``supports_paged_decode =
False``), so ``kv_mode="auto"`` serves it dense.  The logits are an int64
sum of products: exact, and equal to the reference's int32 ``h @ out``
(which never overflows), so the port's engine must replay the reference
engine's token streams byte for byte.
"""

import numpy as np
import torch
from helpers.serving import ToyLM

__all__ = ["TorchToyLM"]


class TorchToyLM:
    MASK = ToyLM.MASK
    supports_paged_decode = False

    def __init__(self, d: int = 8, device="cpu") -> None:
        ref = ToyLM(d)
        self.cfg = ref.cfg
        self.d = d
        self.device = torch.device(device)
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

    def prefill(self, tokens, *, max_seq=None):
        B, S = tokens.shape
        h = torch.zeros((B, self.d), dtype=torch.int32, device=tokens.device)
        for t in range(S):
            h = self._advance(h, tokens[:, t])
        state = {"h": h, "pos": torch.full((B,), S, dtype=torch.int32,
                                           device=tokens.device)}
        return state, self._logits(h)

    def decode_step(self, state, tokens):
        h = self._advance(state["h"], tokens)
        return {"h": h, "pos": state["pos"] + 1}, self._logits(h)
