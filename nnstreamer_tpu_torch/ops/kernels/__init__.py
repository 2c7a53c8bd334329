"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions: the epilogue kernels here, flash attention in
``flash_attention``, the prologue's normalize and quantize in ``preprocess``."""

from .epilogue import (class_reduce, class_reduce_plain, dequant_gelu_requant,
                       dequant_gelu_requant_plain, nms_sweep, nms_sweep_plain,
                       segment_colorize, segment_colorize_plain)
from .preprocess import (normalize_u8, normalize_u8_plain, quantize_affine,
                         quantize_affine_plain)

__all__ = ["class_reduce", "class_reduce_plain", "dequant_gelu_requant",
           "dequant_gelu_requant_plain", "nms_sweep", "nms_sweep_plain",
           "normalize_u8", "normalize_u8_plain", "quantize_affine",
           "quantize_affine_plain", "segment_colorize", "segment_colorize_plain"]
