"""K2 (``csrc/flash_attention.cu``: ``flash_prefill_tc``) against its
roofline, in %: the least time its calls in the profiled stretch need
(``costs.k2_counts`` of each call's shapes) over its device time."""


def read(ctx):
    from perfbench.trace import kernel_seconds

    p, costs = ctx["profile"], ctx["costs"]
    if p is None or not ctx["k2_calls"]:
        return None
    sec, _ = kernel_seconds(p, "flash_prefill_tc")
    if sec <= 0:
        return None
    bound = sum(costs.bound_seconds(*costs.k2_counts(
        ctx["config"], sq, sk, off, causal, window))
        for sq, sk, off, causal, window in ctx["k2_calls"])
    return 100.0 * bound / sec
