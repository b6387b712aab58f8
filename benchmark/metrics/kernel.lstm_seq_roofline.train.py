"""lstm_seq's share of its roofline in the training cells: every launch of
the profiled iterations (both sides' rollout steps and the update's
sequence forward), bound over device time."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train")
