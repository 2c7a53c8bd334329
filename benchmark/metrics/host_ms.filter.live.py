"""tensor_filter's self time a frame on the host: its chain less the downstream
chains it calls (benchmark spans)."""

from benchmark.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "tensor_filter")
