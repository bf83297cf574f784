"""The KV allocator's host ms a decode step: every ``arena.*`` span
(admission, a prefill's write plan, the VMA sample, the decode batch's
reservation, release at retire), over the whole window (its last ~6 s
under the profiler in a traced run)."""

from perfbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, lambda n: float(n.startswith("arena.")))
