"""Mean wait from a request's submit to its admission into a slot, in ms,
over the profiled stretch: the engine's ``serving.admit_wait_seconds``
histogram (its count and sum, read at the stretch's two ends, so the
seconds the profiler takes to stop do not count as waiting)."""


def read(ctx):
    (n0, s0), (n1, s1) = ctx["admit0"], ctx["admit1"]
    if n1 <= n0:
        return None
    return (s1 - s0) / (n1 - n0) * 1e3
