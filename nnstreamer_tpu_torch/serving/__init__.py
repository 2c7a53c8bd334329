"""Serving-side engines built on the model families — port of
nnstreamer_tpu/serving (the contiguous-KV ``LMEngine`` and its token
sampling; the paged KV cache, disaggregation and the tensor-parallel engine
come in later slices)."""

from . import sampling
from .lm_engine import LMEngine, next_pow2_bucket

__all__ = ["LMEngine", "next_pow2_bucket", "sampling"]
