"""Device milliseconds of the kernels launched inside the prefill calls
(``paged_prefill`` and the shared-prefix suffix's ``paged_prefill_at``),
per 1000 tokens they prefilled."""


def read(ctx):
    p = ctx["profile"]
    if p is None:
        return None
    s = sum(p["ranges"].get(k, (0.0, 0))[0]
            for k in ("bench.prefill", "bench.prefill_at"))
    toks = sum(t for t, _ in ctx["prefills"])
    if toks == 0 or s <= 0:
        return None
    return s / (toks / 1000.0) * 1e3
