"""Host ms a decode step inside calls into the model: every ``model.*``
span (decode, the prefills, the page and slot writes, each with the
upload of its inputs), launches included, over the whole window (its last
~6 s under the profiler in a traced run)."""

from perfbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda n: float(n.startswith("model.")))
