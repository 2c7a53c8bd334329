"""The 95th percentile of the latency over every frame of the window."""

from benchmark.harness import readers


def read(ctx):
    return readers.latency_ms(ctx, 95)
