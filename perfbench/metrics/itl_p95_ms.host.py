"""The 95th percentile of the gaps between a request's tokens in the
traced run's window, in ms, for a cell whose device is idle most of the
time: there the gap is paced by the host (engine, sampler, launches)."""


def read(ctx):
    return ctx["e2e"]["itl_p95_ms"]
