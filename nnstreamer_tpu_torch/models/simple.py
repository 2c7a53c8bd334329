"""Tiny built-in models used by tests, probes and examples.

Port of nnstreamer_tpu/models/simple.py. Mirrors the reference's custom
test filters (tests/nnstreamer_example/custom_example_{passthrough,scaler,
average,...}) — scaffolding models standing in for real networks — as
torch functions registered in the zoo, with the JAX package's dtypes
(a Python scale is weakly typed; average casts back saturating).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.types import TensorsInfo
from ..ops.transform_ops import astype, weak_scalar
from .zoo import ModelBundle, register_model


def _info_from(dims: str, types: str) -> TensorsInfo:
    return TensorsInfo.from_strings(dims, types)


def make_passthrough(device: Any = None, dims: str = "3:224:224:1",
                     types: str = "uint8", **_: Any) -> ModelBundle:
    info = _info_from(dims, types)
    return ModelBundle("passthrough", lambda *xs: xs if len(xs) > 1 else xs[0],
                       device=device, in_info=info, out_info=info)


def make_scaler(device: Any = None, dims: str = "3:224:224:1",
                types: str = "float32", scale: str = "2.0",
                **_: Any) -> ModelBundle:
    info = _info_from(dims, types)
    s = float(scale)
    return ModelBundle("scaler", lambda x: x * weak_scalar(s, x), device=device,
                       in_info=info, out_info=info)


def make_average(device: Any = None, dims: str = "3:224:224:1",
                 types: str = "float32", **_: Any) -> ModelBundle:
    """Per-frame global average → one scalar per frame (custom_example_average)."""
    in_info = _info_from(dims, types)
    out_info = TensorsInfo.from_strings("1:1", types)

    def apply(x):
        mean = x.to(torch.float32).mean(dim=tuple(range(1, x.dim())))
        return astype(mean.reshape(-1, 1), x.dtype)

    return ModelBundle("average", apply, device=device, in_info=in_info,
                       out_info=out_info)


def make_matmul(device: Any = None, n: str = "256", batch: str = "1",
                seed: str = "0", **_: Any) -> ModelBundle:
    """Dense layer stand-in: x @ W with a fixed random W. W is seeded with
    numpy (the JAX package draws it with jax.random, so carry its ``params``
    across to compare the two)."""
    dim, b = int(n), int(batch)
    w = (np.random.default_rng(int(seed)).standard_normal((dim, dim))
         / np.sqrt(dim)).astype(np.float32)
    params = torch.from_numpy(w).to(device)
    info = TensorsInfo.from_strings(f"{dim}:{b}", "float32")

    def apply_params(p, x):
        return x @ p

    return ModelBundle("matmul", lambda x: apply_params(params, x),
                       device=device, in_info=info, out_info=info,
                       params=params, apply_params=apply_params)


register_model("passthrough", make_passthrough)
register_model("scaler", make_scaler)
register_model("average", make_average)
register_model("matmul", make_matmul)
