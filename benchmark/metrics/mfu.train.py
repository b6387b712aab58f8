"""The whole training step's share of the card's bf16 peak: model FLOPs of
every lane-step forward of the rollouts (both sides) plus the update's
forward and backward (twice the forward; the recompute not counted), over
the traced run's window."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")
