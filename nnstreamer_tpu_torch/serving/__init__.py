"""Serving-side engines built on the model families — port of
nnstreamer_tpu/serving (``LMEngine`` with the contiguous or the paged KV
cache, its token sampling and ``PagedKVCache``, and ``TPLMEngine``, the
engine over a tensor-parallel mesh; disaggregation is serving/disagg.py)."""

from . import sampling
from .kv_cache import PagedKVCache, prompt_path_hashes
from .lm_engine import LMEngine, next_pow2_bucket
from .tp_engine import TPLMEngine

__all__ = ["LMEngine", "PagedKVCache", "TPLMEngine", "next_pow2_bucket",
           "prompt_path_hashes", "sampling"]
