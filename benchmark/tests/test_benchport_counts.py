"""The frozen FLOP and roofline counts against sums by hand."""

import numpy as np
import pytest

from benchmark.harness import peaks
from benchmark.harness import tflite_writer as tw

import tiny


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table: class_reduce (2916, 90) f32 0.00032032 ms,
    # nms_sweep K 1917 all pairs 0.00035633 ms, segment_colorize 257x257x21
    # 0.00173532 ms
    assert peaks.class_reduce_s(2916, 90) * 1e3 == pytest.approx(0.00032032, rel=1e-4)
    assert peaks.nms_sweep_s(1917, 1917 * 1916 / 2) * 1e3 == pytest.approx(0.00035633, rel=1e-4)
    assert peaks.segment_colorize_s(257 * 257, 21) * 1e3 == pytest.approx(0.00173532, rel=1e-4)
    # by hand: bytes 1917*90*4 + 1917*8 over 3.35 TB/s
    assert peaks.class_reduce_s(1917, 90) == (1917 * 90 * 4 + 1917 * 8) / 3.35e12
    # the sweep's pairs are what the inputs need: fewer pairs, less bound
    assert peaks.nms_sweep_s(1917, 1000) == 6 * 1917 * 4 / 3.35e12


def test_flops_of_one_layer_by_hand():
    from benchmark.configs import ssd_mobilenet_v2_coco as ssd

    net = tw.TFLiteNet()
    x = net.tensor((1, 8, 8, 3), role="input")
    y = net.conv(x, 16, 3, 2)         # 4x4x16 out, 3x3x3 taps
    net.dwconv(y, 1)                  # 4x4x16, 9 taps
    state = {"built": {"net": net}}
    want = 2 * (4 * 4 * 16 * 3 * 3 * 3) + 2 * (4 * 4 * 16 * 9)
    assert ssd.flops_per_frame(state) == want


def test_deeplab_flops_count_every_conv():
    from benchmark.configs import deeplabv3_mnv2_257 as dl
    from benchmark.reference import deeplab

    cfg = tiny.config("deeplab257.files8")
    tree, leaves = deeplab.layout(21)
    variables = deeplab.draw(leaves, 3, "cpu")
    state = {"cfg": dict(cfg, input_size=257), "variables": variables}
    total = dl.flops_per_frame(state)
    # the stem alone: 129x129 outputs, 3x3x3 taps, 32 filters
    stem = 2 * 129 * 129 * 27 * 32
    # the head: 17x17 outputs, 256 in, 21 out
    head = 2 * 17 * 17 * 256 * 21
    assert total > stem + head
    assert 2.5e9 < total < 3.5e9
    n_kernels = sum(1 for p, _, k in leaves if p[-1] == "kernel")
    assert n_kernels == 1 + 17 * 3 - 1 + 1 + 3 + 2 + 1


def test_mfu_and_roofline_readers():
    from benchmark.harness import readers

    # the rate of the window's first part, before the instruments are on
    ctx = {"records": {"done": 500, "seconds": 10.0, "plain_done": 200, "plain_seconds": 4.0},
           "traced": True, "flops_per_frame": 3e9, "peak_flops": 989e12}
    assert readers.mfu_pct(ctx) == pytest.approx(100 * 3e9 * 50 / 989e12)

    class _Tr:
        def kernel(self, *names):
            return (100, 100 * 2e-6) if "class_reduce_kernel" in names else (0, 0.0)

    ctx = {"summary": {"busy_s": 1.0}, "cell": type("C", (), {"tracer": _Tr()})(),
           "work": {"class_reduce_rows": 1917.0, "class_reduce_cols": 90.0}}
    assert readers.roofline_pct(ctx, "class_reduce") == pytest.approx(
        100 * peaks.class_reduce_s(1917, 90) / 2e-6)
    # a kernel that never ran reads nothing, not 0
    ctx["work"]["colorize_pixels"] = 1.0
    ctx["work"]["colorize_classes"] = 1.0
    assert readers.roofline_pct(ctx, "segment_colorize") is None
