"""Share of the prompt tokens admitted in the window that a shared prefix
already held (``prefix_prefill_tokens_saved_total``), against those
saved plus those prefilled, in %."""


def _prefilled(stats):
    return sum(stats["prefill_tokens_total"].values())


def read(ctx):
    s0, s1 = ctx["stats0"], ctx["stats1"]
    saved = (s1["prefix_prefill_tokens_saved_total"]
             - s0["prefix_prefill_tokens_saved_total"])
    total = saved + _prefilled(s1) - _prefilled(s0)
    if total <= 0:
        return None
    return 100.0 * saved / total
