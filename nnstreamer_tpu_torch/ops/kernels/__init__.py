"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions: the epilogue kernels here, flash attention in
``flash_attention``."""

from .epilogue import (class_reduce, class_reduce_plain, dequant_gelu_requant,
                       dequant_gelu_requant_plain, nms_sweep, nms_sweep_plain,
                       segment_colorize, segment_colorize_plain)

__all__ = ["class_reduce", "class_reduce_plain", "dequant_gelu_requant",
           "dequant_gelu_requant_plain", "nms_sweep", "nms_sweep_plain",
           "segment_colorize", "segment_colorize_plain"]
