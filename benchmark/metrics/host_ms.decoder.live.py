"""tensor_decoder's self time a frame on the host: its chain less the sink's (benchmark spans)."""

from benchmark.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "tensor_decoder")
