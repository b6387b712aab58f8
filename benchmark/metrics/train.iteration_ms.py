"""Learner loop: the median host-clock interval between the fused step's
calls over the traced run's window (one iteration each)."""


def read(ctx):
    if ctx.get("family") != "train" or ctx.get("iteration_median_s") is None:
        return None
    return 1e3 * ctx["iteration_median_s"]
