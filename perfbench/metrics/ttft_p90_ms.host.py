"""The 90th percentile of the time to first token in the traced run's
window, in ms, before the profiled stretch, for a cell where the host
paces the first token too closely for it to hold an end-to-end bound."""


def read(ctx):
    return ctx["e2e"]["ttft_p90_ms"]
