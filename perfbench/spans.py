"""Host milliseconds a decode step from the serving engine's spans.

The program keeps each span's count and host seconds in its telemetry
sink and reports them in ``serving_stats()["spans"]`` as
``{name: [count, seconds]}``, totals that only grow.  A reading is the
change of a weighted sum of those seconds between the window's two
snapshots (``stats0``, ``stats1``) over the change of
``decode_steps_total``: the whole window, of which a traced run's last
~6 s (``bench.PROFILE_SECONDS``) run under the profiler.  A program
without spans reads nothing.

``engine.step`` is one call of ``ServingEngine.step()``; ``engine.admit``
and ``engine.prefill`` group leaves; the leaves never nest, so the five
readings below add up to ``engine.step``:

* ``arena.*``: the KV allocator's host work;
* ``model.*``: each call into the model with the upload of its inputs;
* ``engine.logits``: the host waiting for the step's logits;
* ``sampler``: the step's draws;
* the engine's own work: ``engine.step`` less every leaf.
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["is_leaf", "ms_per_step"]


def is_leaf(name: str) -> bool:
    return name.startswith(("arena.", "model.")) or name in (
        "engine.logits", "sampler")


def ms_per_step(ctx, weight: Callable[[str], float]) -> Optional[float]:
    """Sum over spans of ``weight(name)`` times the span's seconds in the
    window, in ms a decode step; None where the program has no spans or
    the window decoded nothing."""
    s0, s1 = ctx["stats0"], ctx["stats1"]
    if "spans" not in s0 or "spans" not in s1:
        return None
    steps = s1["decode_steps_total"] - s0["decode_steps_total"]
    if steps <= 0:
        return None
    a, b = s0["spans"], s1["spans"]
    sec = sum(weight(n) * (b[n][1] - a.get(n, (0, 0.0))[1]) for n in b)
    return sec / steps * 1e3
