"""Byte-level tokenizer (vocab 256 + specials) — the pipeline's default.

Production deployments plug real tokenizers through the same interface;
byte-level keeps the framework self-contained and is exact for round-trip
tests.  IDs ≥ 256 are specials; encode folds arbitrary vocab sizes via
modulo when a model's vocab is smaller than 256 + specials.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

__all__ = ["ByteTokenizer"]


@dataclass(frozen=True)
class ByteTokenizer:
    specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.specials)

    @property
    def pad_id(self) -> int:
        return 256

    @property
    def bos_id(self) -> int:
        return 257

    @property
    def eos_id(self) -> int:
        return 258

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = False) -> np.ndarray:
        ids: List[int] = list(text.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        raw = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                    if 0 <= int(i) < 256)
        return raw.decode("utf-8", errors="replace")

    def pad_batch(self, seqs: Sequence[np.ndarray], length: int) -> np.ndarray:
        out = np.full((len(seqs), length), self.pad_id, np.int32)
        for i, s in enumerate(seqs):
            out[i, : min(len(s), length)] = s[:length]
        return out
