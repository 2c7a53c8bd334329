"""Serving-side engines built on the model families — port of
nnstreamer_tpu/serving (``LMEngine`` with the contiguous or the paged KV
cache, its token sampling and ``PagedKVCache``; disaggregation and the
tensor-parallel engine come in later slices)."""

from . import sampling
from .kv_cache import PagedKVCache, prompt_path_hashes
from .lm_engine import LMEngine, next_pow2_bucket

__all__ = ["LMEngine", "PagedKVCache", "next_pow2_bucket", "prompt_path_hashes",
           "sampling"]
