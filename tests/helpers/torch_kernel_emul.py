"""Plain-PyTorch emulations of the arithmetic of the port's CUDA kernels.

Test-only: they let the CPU tests check a kernel's design (its tile order,
its roundings, its partition of the work) where the kernel itself cannot
run.  They are not a second plain version of any kernel; the package's
plain versions are the ``ref.py`` modules.

* :func:`flash_tc_emul` follows the bf16 tensor-core route of
  ``csrc/flash_attention.cu``: KV tiles of ``BK`` = 64 rows in order (the
  route's tile rows at every head dim, 256 included), S = Q K^T of bf16
  values summed in fp32, the scale applied to fp32 S (inside the exponent
  when there is no softcap), masks, an online softmax in fp32 in base 2,
  and P V as P_hi V + P_lo V with P_hi = bf16(p), P_lo = bf16(p - P_hi)
  (``split_p=False`` rounds p to bf16 once instead).
* :func:`paged_split_emul` follows ``csrc/paged_attention.cu``: splits of
  ``SPLIT_ROWS`` rows of logical pages, warps taking the pages of a split in
  turn, steps of ``rows`` rows with an online softmax in base 2, the warps'
  states combined in warp order, the splits' in split order.
* :func:`wkv6_chunk_emul` follows the bf16 route of ``csrc/wkv6.cu``: chunks
  of ``WKV_CHUNK`` tokens cut into sub-chunks of ``WKV_SUB``, log2 decays
  clamped at ``LOG2_DECAY_FLOOR``, every decay factor ``2**x`` of a sum
  ``x <= 0`` taken from 0 over the tokens it spans (never a difference of
  two cumulative sums), the diagonal sub-blocks as pairwise running
  products, the fp32 operands of the tensor-core products split into two
  TF32 terms (``cvt.rna`` rounding emulated bit for bit; ``split=False``
  rounds each once instead) and the chunk-state scan in chunk order.

``PYTHONPATH=src python tests/helpers/torch_kernel_emul.py`` prints, for
the flash shapes of the tests and for WKV6 on the decay cases of the tests,
how far the fp32 output before its bf16 rounding lies from the fp32 oracle
with the operands split and with them rounded once, as a share of the bf16
limit that ``chip_smoke.py`` holds the kernel to.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0e38
LOG2E = 1.4426950408889634
BK = 64                 # kv rows of a tile (flash, every head dim)
SPLIT_ROWS = 256        # rows of logical pages of a split (paged)
WARPS = 8               # warps of a block (paged)
WKV_CHUNK = 64          # tokens of a chunk (wkv6)
WKV_SUB = 16            # tokens of a sub-chunk: one warp's rows (wkv6)
LOG2_DECAY_FLOOR = -126.0   # log2 w is clamped here (wkv6)

__all__ = ["flash_tc_emul", "paged_split_emul", "tf32", "wkv6_chunk_emul",
           "wkv6_decay"]


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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does it: to nearest,
    ties away from zero, the low 13 mantissa bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, split):
    """a @ b of fp32 operands on TF32 tensor cores: a_hi b_hi + a_hi b_lo +
    a_lo b_hi with x_hi = tf32(x), x_lo = tf32(x - x_hi) (a bf16 operand
    has x_lo = 0, and the kernel skips its term); ``split=False`` rounds
    each operand once."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return ah @ bh
    return ah @ bh + (ah @ tf32(b - bh) + tf32(a - ah) @ bh)


def wkv6_chunk_emul(r, k, v, w, u, state0, *, split=True, out_fp32=False):
    """r/k/v: (B, T, H, hd) bf16; w: (B, T, H, hd) fp32; u: (H, hd);
    state0: (B, H, hd, hd).  Returns (final state fp32, y in r's dtype, or
    the fp32 value before that rounding)."""
    B, T, H, hd = r.shape
    C, Q = WKV_CHUNK, WKV_SUB
    nc = -(-T // C)
    pad = nc * C - T

    def bhtd(x):                    # (B, H, nc * C, hd), zeros past T
        x = x.float().permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    r32, k32, v32 = bhtd(r), bhtd(k), bhtd(v)
    # a padded token has w = 1 (log 0) and k = 0: it changes nothing
    lw = bhtd(torch.clamp(torch.log2(w.float()), min=LOG2_DECAY_FLOOR))
    wc = torch.exp2(lw)
    uk_u = u.float()[None, :, :]                              # (1, H, hd)
    S = state0.float().clone()
    zero = torch.zeros((B, H, hd))
    ys = []
    for n in range(nc):
        ch = slice(n * C, (n + 1) * C)
        R, K, V, LW, WC = (x[:, :, ch] for x in (r32, k32, v32, lw, wc))
        # state kernel: dS = (k * 2^(suffix sum))^T V, D = 2^(chunk sum)
        Kd = torch.empty_like(K)
        q = zero.clone()
        for s in reversed(range(C)):
            Kd[:, :, s] = K[:, :, s] * torch.exp2(q)
            q = q + LW[:, :, s]
        D = torch.exp2(q)
        dS = _mm(Kd.transpose(-1, -2), V, split)
        # output kernel: per sub-chunk prefix (r side) and suffix (k side)
        RQ, KS = torch.empty_like(R), torch.empty_like(K)
        tot = []
        for J in range(C // Q):
            e = zero.clone()
            for t in range(J * Q, (J + 1) * Q):
                RQ[:, :, t] = R[:, :, t] * torch.exp2(e)
                e = e + LW[:, :, t]
            tot.append(e)
            q = zero.clone()
            for s in reversed(range(J * Q, (J + 1) * Q)):
                KS[:, :, s] = K[:, :, s] * torch.exp2(q)
                q = q + LW[:, :, s]
        pre, p = [], zero.clone()
        for J in range(C // Q):
            pre.append(torch.exp2(p))
            p = p + tot[J]
        A = torch.zeros((B, H, C, C))
        for J in range(C // Q):
            rows = slice(J * Q, (J + 1) * Q)
            # the diagonal sub-block: exact pairwise running products
            for tl in range(Q):
                t = J * Q + tl
                A[:, :, t, t] = (R[:, :, t] * (uk_u * K[:, :, t])).sum(-1)
                f = torch.ones((B, H, hd))
                for s in reversed(range(J * Q, t)):
                    A[:, :, t, s] = (R[:, :, t] * K[:, :, s] * f).sum(-1)
                    f = f * WC[:, :, s]
            if J:   # sub-blocks below it: through the boundary J * Q - 1
                kd = KS[:, :, :J * Q].clone()
                for j in range(J - 1):
                    m = zero.clone()
                    for mid in range(j + 1, J):
                        m = m + tot[mid]
                    kd[:, :, j * Q:(j + 1) * Q] *= torch.exp2(m)[:, :, None]
                A[:, :, rows, :J * Q] = _mm(RQ[:, :, rows],
                                            kd.transpose(-1, -2), split)
        Rd = torch.cat([RQ[:, :, J * Q:(J + 1) * Q] * pre[J][:, :, None]
                        for J in range(C // Q)], dim=2)
        ys.append(_mm(A, V, split) + _mm(Rd, S, split))
        S = D[..., None] * S + dS
    y = torch.cat(ys, dim=2)[:, :, :T].permute(0, 2, 1, 3) if ys else \
        torch.zeros((B, T, H, hd))
    return S, (y if out_fp32 else y.to(r.dtype))


def wkv6_decay(kind, shape, rng):
    """fp32 numpy decays w of ``shape`` (B, T, H, hd), the kinds that
    ``chip_smoke.wkv6_decay`` draws on the card: ``sigmoid`` (0.35, 0.95);
    ``law``, RWKV6's w = exp(-exp(dec)) with dec uniform over [-8, 5]
    (w ~ 1 - 3e-4 down to exact 0); ``runs``, per 64-token chunk strong
    decays (w = 0) on the first (7 i) % 64 tokens of channel i, then weak
    ones (w ~ 0.95 to 0.98); ``long``, w ~ 1 - 3e-4 everywhere."""
    if kind == "sigmoid":
        x = rng.standard_normal(shape)
        return (1 / (1 + np.exp(-x)) * 0.6 + 0.35).astype(np.float32)
    jitter = rng.uniform(0.0, 1.0, shape)
    if kind == "law":
        dec = jitter * 13.0 - 8.0
    elif kind == "long":
        dec = jitter - 8.5
    else:
        t = np.arange(shape[1])[:, None] % 64
        edge = np.arange(shape[3])[None, :] * 7 % 64
        dec = np.where(t < edge, 5.0, -3.5)[None, :, None, :] + jitter - 0.5
    with np.errstate(over="ignore"):
        return np.exp(-np.exp(dec)).astype(np.float32)


def _tol_shares():
    """Max |emul - fp32 oracle| of the fp32 output before its bf16 rounding,
    as a share of the bf16 limit of ``chip_smoke.TOL``, with the P split and
    with P rounded once, at the test shapes and the serving shape's
    S=2048 (seeded inputs, K=2, G=2)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import TOL
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    atol, rtol = TOL[torch.bfloat16]
    for S, hd, window, cap in ((64, 64, 0, 0.0), (200, 128, 0, 0.0),
                               (200, 64, 32, 30.0), (2048, 128, 0, 0.0),
                               (200, 256, 48, 50.0)):
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
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    for decay in ("sigmoid", "law", "runs"):
        B, T, H, hd = 1, 2048, 2, 64
        rng = np.random.default_rng(T + hd)
        n = lambda *shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
        r, k, v = (n(B, T, H, hd) * sc for sc in (1.0, 0.3, 1.0))
        r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
        w = torch.from_numpy(wkv6_decay(decay, (B, T, H, hd), rng))
        u, s0 = n(H, hd) * 0.2, n(B, H, hd, hd) * 0.1
        _, ref = wkv6_ref(r.float(), k.float(), v.float(), w, u, s0)
        row = []
        for split in (True, False):
            _, out = wkv6_chunk_emul(r, k, v, w, u, s0, split=split,
                                     out_fp32=True)
            row.append(((out - ref).abs() / (atol + rtol * ref.abs()))
                       .max().item())
        print(f"wkv6 B={B} T={T} H={H} hd={hd} decay {decay}: fp32 output "
              f"vs fp32 oracle, {row[0]:.4f} x the bf16 limit with operands "
              f"split, {row[1]:.4f} x with them rounded once")


if __name__ == "__main__":
    _tol_shares()
