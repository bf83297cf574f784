"""The serving engine's own host ms a decode step: ``engine.step`` less
every leaf span (arena, model, logits, sampler), over the whole window
(its last ~6 s under the profiler in a traced run)."""

from perfbench.spans import is_leaf, ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda n: 1.0 if n == "engine.step"
                       else -1.0 if is_leaf(n) else 0.0)
