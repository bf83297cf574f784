"""Plain-PyTorch emulations of the arithmetic of the port's CUDA kernels.

Test-only: they let the CPU tests check a kernel's design (its tile order,
its roundings, its partition of the work) where the kernel itself cannot
run.  They are not a second plain version of any kernel; the package's
plain versions are the ``ref.py`` modules.

* :func:`flash_tc_emul` follows the bf16 tensor-core route of
  ``csrc/flash_attention.cu``: 64-row KV tiles in order, S = Q K^T of bf16
  values summed in fp32, the scale applied to fp32 S (inside the exponent
  when there is no softcap), masks, an online softmax in fp32 in base 2,
  and P V as P_hi V + P_lo V with P_hi = bf16(p), P_lo = bf16(p - P_hi)
  (``split_p=False`` rounds p to bf16 once instead).
* :func:`paged_split_emul` follows ``csrc/paged_attention.cu``: splits of
  ``SPLIT_ROWS`` rows of logical pages, warps taking the pages of a split in
  turn, steps of ``rows`` rows with an online softmax in base 2, the warps'
  states combined in warp order, the splits' in split order.

``PYTHONPATH=src python tests/helpers/torch_kernel_emul.py`` prints, for
the flash shapes of the tests, how far the fp32 output before its bf16
rounding lies from the fp32 oracle with P split and with P rounded once,
as a share of the bf16 limit that ``chip_smoke.py`` holds the kernel to.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38
LOG2E = 1.4426950408889634
BK = 64                 # kv rows of a tile (flash)
SPLIT_ROWS = 256        # rows of logical pages of a split (paged)
WARPS = 8               # warps of a block (paged)

__all__ = ["flash_tc_emul", "paged_split_emul"]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_tc_emul(q, k, v, window, *, scale, logit_cap=0.0, causal=True,
                  split_p=True, out_fp32=False):
    """q: (B, Sq, K*G, hd) bf16; k/v: (B, Sk, K, hd) bf16.  Returns q's
    layout in bf16 (or the fp32 value before that rounding)."""
    B, Sq, KG, hd = q.shape
    _, Sk, K, _ = k.shape
    G = KG // K
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    unit = LOG2E if logit_cap else scale * LOG2E
    qi = torch.arange(Sq)[:, None]
    m = torch.full((B, KG, Sq, 1), NEG_INF)
    l = torch.zeros((B, KG, Sq, 1))
    acc = torch.zeros((B, KG, Sq, hd))
    for j0 in range(0, Sk, BK):
        s = qf @ kf[:, :, j0:j0 + BK].transpose(-1, -2)     # fp32 sums
        if logit_cap:
            s = logit_cap * torch.tanh(s * scale / logit_cap)
        kj = torch.arange(j0, min(j0 + BK, Sk))[None, :]
        ok = torch.ones((Sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kj <= qi
        if window:
            ok &= qi - kj < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * unit)
        p = torch.where(ok, torch.exp2(s * unit - m_new * unit), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        vt = vf[:, :, j0:j0 + BK]
        hi = _bf16(p)
        pv = hi @ vt
        if split_p:
            pv = pv + _bf16(p - hi) @ vt
        acc = acc * corr + pv
    out = (acc / l.clamp(min=1e-30)).permute(0, 2, 1, 3)
    return out if out_fp32 else out.to(q.dtype)


def paged_split_emul(q, k_pages, v_pages, page_table, lens, *, scale,
                     rows=4):
    """q: (B, K*G, hd); pages: (P, page, K, hd); table: (B, W) int32;
    lens: (B,) int32 — fp32 math, q's dtype out."""
    B, KG, hd = q.shape
    _, page, K, _ = k_pages.shape
    G = KG // K
    W = page_table.shape[1]
    per_split = max(1, SPLIT_ROWS // page)
    out = torch.zeros((B, KG, hd))
    for b in range(B):
        n = int(lens[b])
        n_pages = min(W, -(-n // page)) if n > 0 else 0
        n_splits = -(-n_pages // per_split)
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float() * (scale * LOG2E)
            splits = []
            for sp in range(n_splits):
                lo, hi = sp * per_split, min((sp + 1) * per_split, n_pages)
                warps = []
                for w in range(WARPS):
                    m = torch.full((G,), NEG_INF)
                    l = torch.zeros(G)
                    acc = torch.zeros((G, hd))
                    for p in range(lo + w, hi, WARPS):
                        phys = int(page_table[b, p])
                        if phys < 0:
                            continue
                        live = min(page, n - p * page)
                        for t0 in range(0, live, rows):
                            kr = k_pages[phys, t0:min(t0 + rows, live), kh]
                            vr = v_pages[phys, t0:min(t0 + rows, live), kh]
                            s = qg @ kr.float().T                # (G, r)
                            m_new = torch.maximum(m, s.amax(-1))
                            corr = torch.exp2(m - m_new)
                            pe = torch.exp2(s - m_new[:, None])
                            l = l * corr + pe.sum(-1)
                            acc = acc * corr[:, None] + pe @ vr.float()
                            m = m_new
                    warps.append((m, l, acc))
                splits.append(_combine(warps))
            if splits:                       # a dead row stays exactly 0
                _, l, acc = _combine(splits)
                out[b, kh * G:(kh + 1) * G] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


def _combine(states):
    """(m, l, acc) states merged in list order, in base 2."""
    m_all = torch.stack([m for m, _, _ in states]).amax(0)
    l_all = torch.zeros_like(m_all)
    a_all = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        e = torch.exp2(m - m_all)
        l_all = l_all + l * e
        a_all = a_all + acc * e[:, None]
    return m_all, l_all, a_all


def _tol_shares():
    """Max |emul - fp32 oracle| of the fp32 output before its bf16 rounding,
    as a share of the bf16 limit of ``chip_smoke.TOL``, with the P split and
    with P rounded once, at the test shapes and the serving shape's
    S=2048 (seeded inputs, K=2, G=2)."""
    import sys
    from pathlib import Path

    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import TOL
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    atol, rtol = TOL[torch.bfloat16]
    for S, hd, window, cap in ((64, 64, 0, 0.0), (200, 128, 0, 0.0),
                               (200, 64, 32, 30.0), (2048, 128, 0, 0.0)):
        rng = np.random.default_rng(S + hd)
        mk = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).bfloat16()
        q, k, v = mk(1, S, 4, hd), mk(1, S, 2, hd), mk(1, S, 2, hd)
        scale = hd ** -0.5
        ref = flash_attention_ref(q.float(), k.float(), v.float(), window,
                                  scale=scale, logit_cap=cap)
        row = []
        for split in (True, False):
            out = flash_tc_emul(q, k, v, window, scale=scale, logit_cap=cap,
                                split_p=split, out_fp32=True)
            row.append(((out - ref).abs() / (atol + rtol * ref.abs()))
                       .max().item())
        print(f"S={S} hd={hd} window={window} cap={cap}: fp32 output vs "
              f"fp32 oracle, {row[0]:.4f} x the bf16 limit with P split, "
              f"{row[1]:.4f} x with P rounded once")


if __name__ == "__main__":
    _tol_shares()
