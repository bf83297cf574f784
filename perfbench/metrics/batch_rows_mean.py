"""Mean rows a decode step emitted a token for, over the window: the
engine's ``tokens_total`` over its ``decode_steps_total``."""


def read(ctx):
    s0, s1 = ctx["stats0"], ctx["stats1"]
    steps = s1["decode_steps_total"] - s0["decode_steps_total"]
    if steps <= 0:
        return None
    toks = sum(s1["tokens_total"].values()) - sum(s0["tokens_total"].values())
    return toks / steps
