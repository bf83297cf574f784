"""Host ms a decode step in the sampler, read from inside the program:
the ``sampler`` span around the step's draws, over the whole window (its
last ~6 s under the profiler in a traced run)."""

from perfbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda n: float(n == "sampler"))
