"""Frames whose result reached a sink in the window, over its seconds, all streams together."""

from benchmark.harness import readers


def read(ctx):
    return readers.frames_per_s(ctx)
