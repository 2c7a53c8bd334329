"""Dynamic-activation int8 matmul (w8a8) — port of nnstreamer_tpu/ops/int8.py.

Weights are quantized once, per output channel (absmax over the contracted
axis K); activations per row (per token), right before each GEMM; the
int8·int8 contraction accumulates exactly in int32 and is rescaled by the
outer product of the two scale vectors. Because int32 accumulation is
exact, two execution forms that batch the same GEMMs differently (prefill
against step decode, one stream against many slots) give bit-identical
GEMM results.

The products run through ``torch._int_mm`` on both devices (the JAX
package leaves them to XLA's ``dot_general``, outside any Pallas kernel).
On the card its cuBLASLt path takes K and N in multiples of 8 and only
more than 16 rows. Every GEMM here, int8 or float, pads its rows with
zeros to a multiple of 8 of at least ``MIN_ROWS`` (exact: a zero row
changes no other row), which also runs a decode step's rows through the
same kernel at any slot count. The MLP's inter-GEMM epilogue (dequant, gelu,
requant) is the hand-written ``dequant_gelu_requant`` kernel
(ops/kernels/epilogue.py). The tensor-parallel helpers (``quant_act_global``,
``int8_partial``, ``int8_row_sharded_matmul``) wait for ``parallel/``.

A w8a8 leaf is ``{W8A8_TAG: int8 (..., K, N), "s": float32 (..., N)}``,
the JAX package's layout, so a converted JAX tree serves unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .kernels.epilogue import absmax_scale, dequant_gelu_requant, gelu_tanh

#: dict key tagging a w8a8-quantized weight leaf (int8 payload under the
#: tag, float32 per-output-channel scales under "s")
W8A8_TAG = "__w8a8__"


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., K, N) float weight → ``{W8A8_TAG: int8, "s": float32 (..., N)}``:
    per-output-channel absmax over K, round half to even, clip to ±127.
    Leading axes (a layer stack L) pass through."""
    if w.dim() < 2:
        raise ValueError(f"quantize_weight: need rank>=2, got {tuple(w.shape)}")
    wf = w.to(torch.float32)
    scale = absmax_scale(wf.abs().amax(dim=-2))
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return {W8A8_TAG: q.to(torch.int8), "s": scale.to(torch.float32)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and W8A8_TAG in w


def stack_shape(w: Any) -> Tuple[int, ...]:
    """Shape of a weight leaf, quantized or not (the int8 payload keeps the
    float weight's shape)."""
    return tuple((w[W8A8_TAG] if is_quantized(w) else w).shape)


def layer(w: Any, i: int) -> Any:
    """Layer ``i`` of a stacked leaf, quantized or not."""
    if is_quantized(w):
        return {W8A8_TAG: w[W8A8_TAG][i], "s": w["s"][i]}
    return w[i]


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic activation quant: (..., K) float → (int8, float32
    (..., 1) scales), each token on its own grid."""
    xf = x.to(torch.float32)
    s = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


#: the fewest rows a GEMM runs with (zero rows pad the rest, which changes
#: no result row): cuBLAS picks its kernel by the row count, so padding
#: makes a decode step of up to this many slots run the same kernel for
#: every row, and a slot's row has the same bits batched as alone (the
#: serving engine's exactness contract); the card's int8 GEMM also refuses
#: 16 rows or fewer
MIN_ROWS = 32


def _gemm(x: torch.Tensor, w: torch.Tensor, mm,
          row_blocks: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) → (..., N) through ``mm`` on 2-D operands, the
    rows padded with zeros to a multiple of 8 and at least ``MIN_ROWS``.
    ``row_blocks`` pads to a multiple of ``MIN_ROWS`` instead and runs one
    ``MIN_ROWS``-row product per block, so every row gets the bits it gets
    in a product of any other row count (cuBLAS picks its float kernels,
    and their summation order, by the row count)."""
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    a = x.reshape(-1, k)
    m = a.shape[0]
    step = MIN_ROWS if row_blocks else 8
    pad = max(MIN_ROWS, -(-m // step) * step) - m
    if pad:
        a = torch.cat([a, a.new_zeros((pad, k))])
    a = a.contiguous()
    if row_blocks and a.shape[0] > MIN_ROWS:
        y = torch.cat([mm(a[i:i + MIN_ROWS], w)
                       for i in range(0, a.shape[0], MIN_ROWS)])
    else:
        y = mm(a, w)
    return y[:m].reshape(lead + (w.shape[-1],))


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 → (..., N) int32, exact."""
    return _gemm(xq, wq, torch._int_mm)


def int8_matmul(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (..., K) float @ quantized w (K, N) → (..., N) in x's dtype:
    ``(f32(y) · xs) · w.s``, then the cast (the JAX package's order)."""
    xq, xs = quant_act(x)
    y = _int_mm(xq, w[W8A8_TAG])
    return ((y.to(torch.float32) * xs) * w["s"]).to(x.dtype)


def mlp_matmul(x: torch.Tensor, w1: Any, w2: Any,
               row_blocks: bool = False) -> torch.Tensor:
    """The transformer MLP ``gelu(x @ w1) @ w2`` (tanh gelu, as
    ``jax.nn.gelu``). When both weights are w8a8, the two GEMMs run int8
    and the chain between them — dequant by xs·w1.s, gelu, per-row requant
    — is one ``dequant_gelu_requant`` launch; bit-identical to
    ``matmul_any(gelu(matmul_any(x, w1)), w2)``. ``row_blocks`` as for
    ``matmul_any``."""
    if not (is_quantized(w1) and is_quantized(w2)):
        return matmul_any(gelu_tanh(matmul_any(x, w1, row_blocks)), w2,
                          row_blocks)
    xq, xs = quant_act(x)
    y = _int_mm(xq, w1[W8A8_TAG])
    hq, hs = dequant_gelu_requant(y, xs, w1["s"], out_dtype=x.dtype)
    y2 = _int_mm(hq, w2[W8A8_TAG])
    return ((y2.to(torch.float32) * hs) * w2["s"]).to(x.dtype)


def matmul_any(x: torch.Tensor, w: Any, row_blocks: bool = False) -> torch.Tensor:
    """``x @ w`` that dispatches on the leaf: float weights take the
    ordinary matmul (mixed float dtypes promote as in JAX: bf16 with f32
    gives f32), w8a8 dicts the int8 path. ``row_blocks`` makes each row's
    bits independent of the row count (``_gemm``); the int8 path's int32
    accumulation is exact at any row count already."""
    if is_quantized(w):
        return int8_matmul(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return _gemm(x, w, torch.matmul, row_blocks)
