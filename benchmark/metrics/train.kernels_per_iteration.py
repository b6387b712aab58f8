"""Rollout and update issue: device kernels in the profiled sub-window over
the iterations it holds."""

from benchmark.readers import device_kernels


def read(ctx):
    prof = ctx.get("profile")
    if ctx.get("family") != "train" or prof is None or not ctx.get("profiled_calls"):
        return None
    n = device_kernels(prof)
    return None if n is None else n / ctx["profiled_calls"]
