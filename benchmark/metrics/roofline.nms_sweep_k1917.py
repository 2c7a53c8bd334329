"""nms_sweep's K 1917 route (build and sweep kernels): the least time of the
IoU pairs these inputs need over its mean device time a call."""

from benchmark.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "nms_sweep_k1917")
