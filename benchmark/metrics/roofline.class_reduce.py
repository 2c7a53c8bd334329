"""class_reduce's least time from its bytes over its mean device time a call."""

from benchmark.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "class_reduce")
