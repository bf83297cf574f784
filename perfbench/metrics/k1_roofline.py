"""K1 (``csrc/paged_attention.cu``: ``paged_split_kernel`` and
``paged_combine_kernel``) against its roofline, in %: the least time the
decode calls of the profiled stretch need (each layer's call over the
live lanes' rows, ``costs.k1_counts``) over the kernels' device time."""

KERNELS = ("paged_split_kernel", "paged_combine_kernel")


def read(ctx):
    from perfbench.trace import kernel_seconds

    p, costs = ctx["profile"], ctx["costs"]
    if p is None or not ctx["decode_lens"]:
        return None
    sec, _ = kernel_seconds(p, *KERNELS)
    if sec <= 0:
        return None
    L = ctx["config"]["num_layers"]
    bound = sum(costs.bound_seconds(*costs.k1_counts(
        ctx["config"], lens, ctx["page_size"])) for lens in ctx["decode_lens"])
    return 100.0 * L * bound / sec
