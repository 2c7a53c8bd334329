"""The configuration's convolution FLOPs (counted from its shapes) times the
frames a second of the traced window's first part, before any instrument is
on, over the peak of the arithmetic it runs in."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
