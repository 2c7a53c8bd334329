"""The 95th percentile of how late each push of the camera generator ran behind its due time."""

from benchmark.harness import readers


def read(ctx):
    return readers.lag_ms(ctx, 95)
