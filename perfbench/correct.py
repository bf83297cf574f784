"""The comparison that decides ``correct``: served tokens against the
plain reference.

Once the window has closed, a sample drawn from the seed of the requests
the program finished in it (the longest among them) is run through the
reference once, each prompt with its served tokens, and every served
token is judged by how far its reference logit lies below the
reference's best at that position.  The widest such gap is compared
with the cell's limit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sample", "streams", "gaps_of_tokens", "gaps_of_argmax"]

_MASK = (1 << 63) - 1


def sample(finished: Sequence, seed: int, n: int) -> List:
    """Up to ``n`` of ``finished`` (records of requests that ended without
    an error): the longest (prompt and output), then others drawn from
    the seed."""
    ok = [r for r in finished if r.request.error is None and r.request.tokens]
    if not ok:
        return []
    size = lambda r: len(r.request.prompt) + len(r.request.tokens)
    longest = max(ok, key=size)
    rest = [r for r in ok if r is not longest]
    rng = np.random.default_rng([int(seed) & _MASK, 5])
    pick = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def streams(requests: Sequence, device) -> Tuple[list, list, list]:
    """The token stream the program consumed for each request (its prompt,
    the prompt's last token again, then its tokens but the last), the rows
    whose logits chose the served tokens, and those tokens."""
    out, rows, served = [], [], []
    for r in requests:
        prompt = np.asarray(r.prompt, np.int64)
        toks = np.asarray(r.tokens, np.int64)
        s = np.concatenate([prompt, prompt[-1:], toks[:-1]])
        out.append(torch.as_tensor(s, device=device))
        rows.append(slice(len(prompt), len(prompt) + len(toks)))
        served.append(torch.as_tensor(toks, device=device))
    return out, rows, served


def gaps_of_tokens(ref_logits: Sequence[torch.Tensor],
                   served: Sequence[torch.Tensor]) -> np.ndarray:
    """Per served token: the reference's best logit less its logit."""
    out = []
    for lg, t in zip(ref_logits, served):
        g = lg.max(dim=-1).values - lg.gather(-1, t[:, None])[:, 0]
        out.append(g.double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def gaps_of_argmax(ref_logits: Sequence[torch.Tensor],
                   other_logits: Sequence[torch.Tensor]) -> np.ndarray:
    """Per position: the gap, under the reference, of the token that
    ``other_logits`` put first."""
    return gaps_of_tokens(ref_logits,
                          [o.argmax(dim=-1) for o in other_logits])
