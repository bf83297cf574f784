"""Share of the profiled stretch in which no kernel, copy or set ran on
the device, in %."""


def read(ctx):
    p = ctx["profile"]
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
