"""The whole step's share of the chip's bf16 peak, in %: the useful model
FLOPs of every token prefilled (tokens a shared prefix held are not
counted) or decoded (live lanes only) in the profiled stretch, over the
stretch's length times 989 TFLOP/s."""


def read(ctx):
    p, costs, cfg = ctx["profile"], ctx["costs"], ctx["config"]
    if p is None or p["busy_s"] <= 0:
        return None
    flops = sum(costs.decode_flops(cfg, lens) for lens in ctx["decode_lens"])
    flops += sum(costs.prefill_flops(cfg, t, start)
                 for t, start in ctx["prefills"])
    if flops <= 0:
        return None
    return 100.0 * flops / (p["window_s"] * costs.PEAK_BF16_FLOPS)
