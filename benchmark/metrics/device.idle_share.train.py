"""The share of the profiled training sub-window in which no operation ran
on the card."""

from benchmark.readers import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx, "train")
