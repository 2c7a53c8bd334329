"""The median latency over every frame of the window, timed as the mix defines it."""

from benchmark.harness import readers


def read(ctx):
    return readers.latency_ms(ctx, 50)
