"""Host milliseconds in the engine's calls to ``sample_token``, per
decode step, over the profiled stretch (the benchmark's timed wrapper)."""


def read(ctx):
    steps = len(ctx["decode_lens"])
    if steps == 0:
        return None
    return ctx["sampler_s"] / steps * 1e3
