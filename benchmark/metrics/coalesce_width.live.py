"""Items a batch of the DeviceEngine at the window's end (coalesce_stats' mean
over its last 4096 batches at most)."""

from benchmark.harness import readers


def read(ctx):
    return readers.coalesce_width(ctx)
