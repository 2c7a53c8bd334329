"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions."""

from .epilogue import (class_reduce, class_reduce_plain, nms_sweep,
                       nms_sweep_plain, segment_colorize,
                       segment_colorize_plain)

__all__ = ["class_reduce", "class_reduce_plain", "nms_sweep",
           "nms_sweep_plain", "segment_colorize", "segment_colorize_plain"]
