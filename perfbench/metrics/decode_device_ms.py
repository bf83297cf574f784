"""Device milliseconds of the kernels launched inside one
``paged_decode_step`` call (the ``bench.decode`` range), per call."""


def read(ctx):
    p = ctx["profile"]
    if p is None or "bench.decode" not in p["ranges"]:
        return None
    s, n = p["ranges"]["bench.decode"]
    if n == 0 or s <= 0:
        return None
    return s / n * 1e3
