"""Host ms a decode step waiting for the logits: the ``engine.logits``
span (the cast and the copy to the host, which waits for the card to
finish the step), over the whole window (its last ~6 s under the
profiler in a traced run)."""

from perfbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda n: float(n == "engine.logits"))
