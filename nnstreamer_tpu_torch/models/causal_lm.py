"""Causal transformer LM with a streaming KV-cache decode step — port of
nnstreamer_tpu/models/causal_lm.py.

Parameters keep the JAX package's layout, so a converted JAX tree
(models/convert.causal_lm_params) computes the same function: ``x @ w``
with w (K, N); the GEMM stacks wqkv (L, D, 3D), wo (L, D, D), w1 (L, D, F),
w2 (L, F, D) and the norms ln1/ln2 (L, D) carry a leading layer axis;
``embed`` (V, D) doubles as the unembedding; ``pos_embed`` (max_len, D).
A w8a8 tree (``quantize_lm_params``) holds ``{"__w8a8__", "s"}`` dicts for
the four GEMM stacks and runs every execution form through the same
``matmul_any``/``mlp_matmul`` sites (ops/int8.py).

Execution forms: the full causal forward (``lm_forward``, the oracle),
prefill (``lm_prefill``: dense, or the hand-written flash kernel per layer
with ``flash=True`` / ``NNS_LM_FLASH=1``; ``lm_prefill_masked`` for a
right-padded prompt), the decode step and the speculative verify window
(``lm_decode_step``, ``lm_verify_window``) and their per-slot forms for
continuous batching (``*_slots``), and the serving engines' admit prefill
(``lm_prefill_window``). Exactness between forms is the
family's contract: step decoding reproduces the forward's logits.

Contracts carried over, each pinned by a CPU test:
  * float32 matmuls run in full float32: every form runs under
    ``torch.set_float32_matmul_precision("highest")`` (no TF32);
  * LayerNorm has no bias, ε = 1e-6, and computes (x − μ)·rsqrt(var + ε)·scale;
  * the dense mask fill is −1e30, not −inf;
  * a window past the cache (pos + W > max_len) clamps its pos_embed slice
    and its cache write to the last W rows, as ``dynamic_slice`` and
    ``dynamic_update_slice`` clamp their start, and NaN-poisons its logits;
  * new K/V are cast to the cache's dtype before the write.

Unlike JAX's functional updates, the step forms write their K/V into the
caches they are given, in place, and return those same tensors: a serving
engine's stores (hundreds of MB at serving widths) are never copied per
step. The paged forms (``lm_prefill_paged``, ``lm_verify_window_paged``,
``lm_decode_step_paged``) gather a slot's pages from a serving/kv_cache.py
pool into that layout, run the same body and scatter the touched pages back
into the pool, in place.

The step forms are batch-invariant, which the serving engine's exactness
contract needs (a stream's tokens equal its isolated run's, and a paged
engine's its contiguous run's): a row gets the same bits in a step of any
slot count, in a verify window of any width and in a prompt's prefill
window (``lm_prefill_window``, the engines' admit prefill) as alone.
LayerNorm sums its statistics in float64, the GEMMs run in blocks of
``ops.int8.MIN_ROWS`` rows (ops/int8.py) and the step's attention is
products and pairwise-tree sums (``_attend_cache``), because PyTorch's
float32 reductions and cuBLAS pick their kernels by the batch.

Cache transport layout: rank-3 ``(layers·batch·heads, max_len, head_dim)``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..core.hw import resolve_device
from ..core.types import TensorsInfo
from ..ops.int8 import layer as _layer
from ..ops.int8 import matmul_any, mlp_matmul, quantize_weight, stack_shape
from ..ops.kernels.flash_attention import flash_attention
from .zoo import ModelBundle, register_model

Params = Dict[str, Any]

#: the dense attention mask's fill: finite, as the JAX package's
_MASK = -1e30
#: LayerNorm epsilon
_LN_EPS = 1e-6
#: the four GEMM stacks (the leaves w8a8 quantizes)
GEMM_KEYS = ("wqkv", "wo", "w1", "w2")


def init_causal_lm(seed: int, vocab: int, d_model: int, n_heads: int,
                   n_layers: int, max_len: int,
                   d_ff: int = 0) -> Dict[str, np.ndarray]:
    """Seeded placeholder parameters as float32 numpy arrays, in the JAX
    package's layout and with ``init_causal_lm``'s statistics (normal ·
    0.02 embeddings, normal / sqrt(fan-in) GEMM stacks, unit norms). The
    draws are numpy's, not ``jax.random``'s: parity with the JAX package
    comes from converting its params, never from matching its bits."""
    d_ff = d_ff or 4 * d_model
    rng = np.random.default_rng(seed)
    s, sf, L = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff), n_layers

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    return {
        "embed": normal((vocab, d_model), 0.02),
        "pos_embed": normal((max_len, d_model), 0.02),
        "wqkv": normal((L, d_model, 3 * d_model), s),
        "wo": normal((L, d_model, d_model), s),
        "w1": normal((L, d_model, d_ff), s),
        "w2": normal((L, d_ff, d_model), sf),
        "ln1": np.ones((L, d_model), np.float32),
        "ln2": np.ones((L, d_model), np.float32),
        "lnf": np.ones((d_model,), np.float32),
    }


def quantize_lm_params(params: Params) -> Params:
    """w8a8 serving form of an LM param tree: the four GEMM stacks become
    int8 payloads plus per-output-channel scales (ops/int8.quantize_weight);
    embeddings and norms stay float."""
    qp = dict(params)
    for k in GEMM_KEYS:
        qp[k] = quantize_weight(params[k])
    return qp


@contextlib.contextmanager
def _full_f32() -> Iterator[None]:
    """Full float32 matmuls for the call (the JAX package pins
    ``default_matmul_precision("float32")``): a caller's TF32 setting is
    lifted for the duration and restored after."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # the statistics are summed in float64 and rounded once to x's dtype:
    # a float32 reduction splits a row over lanes by how many rows it
    # reduces, so a slot's row would get other bits batched than alone
    mu = x.mean(-1, keepdim=True, dtype=torch.float64).to(x.dtype)
    d = x - mu
    var = (d * d).mean(-1, keepdim=True, dtype=torch.float64).to(x.dtype)
    return d * torch.rsqrt(var + _LN_EPS) * scale


def _promote(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """JAX's promotion for a mixed-dtype product (bf16 with f32 → f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def _sqrt_d(q: torch.Tensor) -> torch.Tensor:
    """sqrt(head dim) as a float32 tensor on q's device: a divisor that is
    a Python scalar becomes a multiply by its reciprocal on the card."""
    return torch.full((), math.sqrt(q.shape[-1]), dtype=torch.float32, device=q.device)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Dense masked softmax attention over (..., Lq, hd) × (..., Lk, hd)."""
    q, k, v = _promote(q, k, v)
    s = (q @ k.transpose(-1, -2)) / _sqrt_d(q)
    s = torch.where(mask, s, _MASK)
    return torch.softmax(s, dim=-1) @ v


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed pairwise tree: zero-padded to a power of
    two, then the upper half added to the lower, elementwise, until one is
    left. Each sum's order, so its bits, depends on the length alone; a
    reduction kernel splits a row by how many rows it reduces (PyTorch's
    ``sum`` gives a slot's row other bits in a step of 32 slots than
    alone)."""
    dim %= x.dim()
    n = x.shape[dim]
    p2 = 1 << max(0, n - 1).bit_length()
    if p2 != n:
        x = torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, p2 - n])
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  live: torch.Tensor) -> torch.Tensor:
    """``_attend`` of a step's (..., W, hd) queries over (..., M, hd)
    caches, as products and pairwise-tree sums (``_tree_sum``): cuBLAS's
    batched GEMM picks its kernel by the batch count and PyTorch's
    reductions split a row by the row count, so either would give a row
    other bits with other rows beside it; here each row's bits depend only
    on its own query, the cache and M (the softmax reduces each row on its
    own).

    The softmax's sum is a tree sum too, so columns masked for every row
    contribute exact zeros to power-of-two-aligned halves: attending only
    the first ``cols`` columns (a power of two covering every live column)
    gives the bits of attending all of them."""
    q, k, v = _promote(q, k, v)
    s = _tree_sum(q.unsqueeze(-2) * k.unsqueeze(-3), -1) / _sqrt_d(q)
    s = torch.where(live, s, _MASK)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / _tree_sum(e, -1).unsqueeze(-1)
    return _tree_sum(p.unsqueeze(-1) * v.unsqueeze(-3), -2)


def attend_cols(reach: int, max_len: int) -> int:
    """The columns a window whose rows attend no column at or past ``reach``
    needs: the power of two covering ``reach`` (``max_len`` at most). With
    ``_attend_cache``'s tree sums the result is bit-equal to attending all
    ``max_len`` columns."""
    return min(max_len, 1 << max(0, reach - 1).bit_length())


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, length, d = t.shape
    return t.reshape(b, length, n_heads, d // n_heads).transpose(1, 2)


def _block_body(h: torch.Tensor, params: Params, li: int,
                mask: Optional[torch.Tensor], n_heads: int, attention_fn=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transformer block over a full (masked) sequence; returns the new
    hidden state and this layer's per-head K/V (B, H, T, hd). The one
    definition every full-sequence form shares; ``attention_fn`` (q, k, v)
    → o replaces the dense causal attention and applies causality itself."""
    d_model = h.shape[-1]
    a = _ln(h, params["ln1"][li])
    q, k, v = torch.split(matmul_any(a, _layer(params["wqkv"], li)), d_model,
                          dim=-1)
    qh, kh, vh = (_split_heads(z, n_heads) for z in (q, k, v))
    o = attention_fn(qh, kh, vh) if attention_fn is not None \
        else _attend(qh, kh, vh, mask)
    o = o.transpose(1, 2).reshape(h.shape[:-1] + (o.shape[-1] * n_heads,))
    h = h + matmul_any(o, _layer(params["wo"], li))
    m = _ln(h, params["ln2"][li])
    return h + mlp_matmul(m, _layer(params["w1"], li),
                          _layer(params["w2"], li)), kh, vh


def _unembed(x: torch.Tensor, params: Params) -> torch.Tensor:
    return matmul_any(_ln(x, params["lnf"]), params["embed"].T)


def lm_forward(params: Params, tokens: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    """Full causal forward (the oracle): (B, T) int → (B, T, vocab)."""
    with _full_f32():
        t = tokens.shape[1]
        x = params["embed"][tokens.long()] + params["pos_embed"][:t][None]
        mask = torch.ones((t, t), dtype=torch.bool,
                          device=x.device).tril()
        for li in range(stack_shape(params["wqkv"])[0]):
            x, _, _ = _block_body(x, params, li, mask, n_heads)
        return _unembed(x, params)


def lm_prefill(params: Params, tokens: torch.Tensor, n_heads: int,
               max_len: int, flash: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Process a whole prompt in one forward and emit the populated cache.

    tokens: (B, T) int with T <= max_len. Returns (logits_last (B, vocab),
    kcache, vcache, pos = [T]) in the flat transport layout. ``flash=True``
    swaps the dense attention for the hand-written flash kernel (one
    launch per layer, no (T, T) score matrix); ``None`` reads
    ``NNS_LM_FLASH=1``. The JAX package's sequence-parallel ``mesh=`` form
    waits for the port of parallel/."""
    with _full_f32():
        return _lm_prefill(params, tokens, n_heads, max_len, flash)


def _lm_prefill(params: Params, tokens: torch.Tensor, n_heads: int,
                max_len: int, flash: Optional[bool] = None,
                true_len: Union[int, torch.Tensor, None] = None):
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(
            f"lm_prefill: prompt length {t} exceeds max_len={max_len}")
    if true_len is not None and flash:
        raise ValueError(
            "lm_prefill: true_len= (padded-prompt masking) is a "
            "dense-attention feature; the flash path applies causality "
            "internally and cannot see it")
    if true_len is not None and not isinstance(true_len, torch.Tensor):
        if not 1 <= int(true_len) <= t:
            raise ValueError(
                f"lm_prefill: true_len={int(true_len)} outside [1, {t}] "
                "(padded prompt length)")
    n_layers = stack_shape(params["wqkv"])[0]
    d_model = params["embed"].shape[1]
    hd = d_model // n_heads
    x = params["embed"][tokens.long()] + params["pos_embed"][:t][None]
    attn = mask = tl = None
    if true_len is not None:
        # one device scalar whether the caller gave an int or a tensor (a
        # CUDA graph replays the tensor form for every prompt length)
        tl = true_len.to(x.device, torch.int64).reshape(()) \
            if isinstance(true_len, torch.Tensor) \
            else torch.full((), int(true_len), dtype=torch.int64,
                            device=x.device)
    if true_len is None and (flash if flash is not None
                             else os.environ.get("NNS_LM_FLASH", "") == "1"):
        # (true_len keeps the dense branch even under NNS_LM_FLASH=1: the
        # kernel cannot column-mask a padded prompt)
        def attn(qh, kh, vh):
            return flash_attention(qh, kh, vh, causal=True)
    else:
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        if true_len is not None:
            mask = mask & (torch.arange(t, device=x.device) < tl)[None, :]
    kc = vc = None
    for li in range(n_layers):
        x, kh, vh = _block_body(x, params, li, mask, n_heads, attn)
        if kc is None:
            kc = kh.new_zeros((n_layers, b, n_heads, max_len, hd))
            vc = vh.new_zeros((n_layers, b, n_heads, max_len, hd))
        kc[li, :, :, :t] = kh
        vc[li, :, :, :t] = vh
    if tl is None:
        last = x[:, -1:]
        pos = torch.full((1,), t, dtype=torch.int32, device=x.device)
    else:
        last = x.index_select(1, (tl - 1).reshape(1))
        pos = tl.reshape(1).to(torch.int32)
    logits = _unembed(last, params)[:, 0]
    flat = (n_layers * b * n_heads, max_len, hd)
    return logits, kc.reshape(flat), vc.reshape(flat), pos


def lm_prefill_masked(params: Params, tokens: torch.Tensor,
                      true_len: Union[int, torch.Tensor],
                      n_heads: int, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Prefill a right-padded prompt exactly: tokens (1, Tb) with the real
    prompt in the first ``true_len`` positions. Attention columns are
    limited to col < true_len and the logits come from row true_len − 1;
    K/V written at positions >= true_len are garbage that a decode step
    overwrites before it can attend to them. Returns (logits (1, vocab),
    kcache, vcache, pos = [true_len]). ``true_len`` is an int (checked
    against the padded length) or a 0-dim integer tensor on any device,
    as the JAX engine traces it: the column mask, the logits row (a
    gather) and ``pos`` all come from it on the device, unchecked, so one
    CUDA graph per padded length serves every prompt length."""
    with _full_f32():
        return _lm_prefill(params, tokens, n_heads, max_len,
                           true_len=true_len)


def _verify_window(params: Params, tokens: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, pos: torch.Tensor, n_heads: int,
                   cols: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one body of every step form. tokens (S, B, W); kc/vc views
    (S, L, B, H, max_len, hd), written in place; pos (S,) int, each
    stream's next write position. Returns (logits (S, B, W, vocab),
    pos + W). Query row j of a window attends cache columns <= pos + j.
    ``cols`` (``attend_cols`` of the window's reach, pos + W) restricts the
    attention to the columns any row can see; the bits are those of
    attending all max_len."""
    s_, b, w = tokens.shape
    n_layers, max_len = kc.shape[1], kc.shape[4]
    d_model = params["embed"].shape[1]
    hd = d_model // n_heads
    dev = kc.device
    p = pos.reshape(s_).to(torch.int64)
    ar_w = torch.arange(w, device=dev)
    pe = params["pos_embed"]
    pe_rows = pe[(p.clamp(0, pe.shape[0] - w))[:, None] + ar_w]  # (S, W, D)
    x = params["embed"][tokens.long()] + pe_rows[:, None]
    cols = max_len if cols is None else cols
    live = (torch.arange(cols, device=dev)[None, None, :]
            <= (p[:, None] + ar_w)[:, :, None])[:, None, None]  # (S,1,1,W,C)
    rows = (p.clamp(0, max_len - w)[:, None] + ar_w)  # (S, W): clamped start
    slot = torch.arange(s_, device=dev)[:, None]
    # every GEMM runs in MIN_ROWS-row blocks: a row's bits are then the same
    # in a decode step, a wide verify window or a prompt's prefill window
    for li in range(n_layers):
        a = _ln(x, params["ln1"][li])
        q, k, v = torch.split(matmul_any(a, _layer(params["wqkv"], li), True),
                              d_model, dim=-1)  # (S, B, W, D)
        q = q.reshape(s_, b, w, n_heads, hd).permute(0, 1, 3, 2, 4)
        kl, vl = kc[:, li], vc[:, li]  # (S, B, H, M, hd)
        # (S, M, B, H, hd) views: index (slot, row) takes (S, W, B, H, hd)
        kl.permute(0, 3, 1, 2, 4)[slot, rows] = \
            k.reshape(s_, b, w, n_heads, hd).permute(0, 2, 1, 3, 4).to(kc.dtype)
        vl.permute(0, 3, 1, 2, 4)[slot, rows] = \
            v.reshape(s_, b, w, n_heads, hd).permute(0, 2, 1, 3, 4).to(vc.dtype)
        o = _attend_cache(q, kl[..., :cols, :], vl[..., :cols, :],
                          live)  # (S, B, H, W, hd)
        o = o.permute(0, 1, 3, 2, 4).reshape(s_, b, w, d_model)
        x = x + matmul_any(o, _layer(params["wo"], li), True)
        m = _ln(x, params["ln2"][li])
        x = x + mlp_matmul(m, _layer(params["w1"], li),
                           _layer(params["w2"], li), True)
    logits = matmul_any(_ln(x, params["lnf"]), params["embed"].T, True)
    # a window past capacity surfaces as NaN logits, not as a silent
    # clamped overwrite of the last slots
    over = (p + w > max_len).reshape(s_, 1, 1, 1)
    logits = torch.where(over, torch.nan, logits)
    return logits, p + w


def lm_prefill_window(params: Params, tokens: torch.Tensor,
                      true_len: Union[int, torch.Tensor], n_heads: int,
                      max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Prefill a right-padded prompt as one verify window at position 0 over
    an empty cache of capacity ``max_len``: the serving engines' admit
    prefill. tokens (1, Tb) with the prompt in the first ``true_len``
    positions (an int or a device scalar). Row j attends columns <= j, so
    the logits of row true_len − 1 see the prompt alone, and the padded
    rows' K/V are garbage a decode step overwrites before it can attend to
    them, as with ``lm_prefill_masked``, which computes the same function.

    Unlike ``lm_prefill_masked`` (dense attention, one GEMM of Tb rows),
    every row here is computed as a decode step or a paged prefix-hit
    window computes it (``_verify_window``: products and tree sums over the
    ``max_len`` columns, GEMMs in MIN_ROWS-row blocks), so a prompt's K/V
    and first token have the same bits whichever route admits it.

    Returns (logits (1, vocab), kcache, vcache, pos = [true_len]) in the
    flat transport layout."""
    with _full_f32():
        n_layers = stack_shape(params["wqkv"])[0]
        d_model = params["embed"].shape[1]
        dev = params["embed"].device
        shape = (1, n_layers, 1, n_heads, max_len, d_model // n_heads)
        kc = torch.zeros(shape, dtype=torch.float32, device=dev)
        vc = torch.zeros(shape, dtype=torch.float32, device=dev)
        logits, _ = _verify_window(params, tokens[None], kc, vc,
                                   torch.zeros(1, dtype=torch.int64, device=dev),
                                   n_heads, attend_cols(tokens.shape[1], max_len))
        tl = true_len.to(dev, torch.int64).reshape(()) \
            if isinstance(true_len, torch.Tensor) \
            else torch.full((), int(true_len), dtype=torch.int64, device=dev)
        flat = (n_layers * n_heads,) + shape[-2:]
        return (logits[0, 0].index_select(0, (tl - 1).reshape(1)),
                kc.view(flat), vc.view(flat), tl.reshape(1).to(torch.int32))


def _stream_caches(kcache: torch.Tensor, vcache: torch.Tensor, s_: int,
                   n_layers: int, n_heads: int):
    """Flat transport caches → (S, L, B, H, max_len, hd) views."""
    lbh, max_len, hd = kcache.shape[-3:]
    b = lbh // (n_layers * n_heads)
    shape = (s_, n_layers, b, n_heads, max_len, hd)
    return kcache.view(shape), vcache.view(shape)


def lm_verify_window(params: Params, tokens: torch.Tensor,
                     kcache: torch.Tensor, vcache: torch.Tensor,
                     pos: torch.Tensor, n_heads: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Speculative verify: consume a window of W tokens at cache positions
    pos..pos+W−1 and return logits at every window position.

    tokens (B, W) int; caches in the flat transport layout (written in
    place); pos (1,) int. Returns (logits (B, W, vocab), kcache, vcache,
    pos + W). Windows past capacity NaN-poison their logits."""
    with _full_f32():
        n_layers = stack_shape(params["wqkv"])[0]
        kc, vc = _stream_caches(kcache, vcache, 1, n_layers, n_heads)
        logits, p = _verify_window(params, tokens[None], kc, vc,
                                   pos.reshape(1), n_heads)
        return logits[0], kcache, vcache, p.to(torch.int32)


def lm_decode_step(params: Params, token: torch.Tensor, kcache: torch.Tensor,
                   vcache: torch.Tensor, pos: torch.Tensor, n_heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """One streaming decode step, the W = 1 verify window: token (B, 1);
    returns (logits (B, vocab), kcache, vcache, pos + 1). Decoding past
    capacity NaN-poisons the logits."""
    logits, kc, vc, pos = lm_verify_window(params, token, kcache, vcache,
                                           pos, n_heads)
    return logits[:, 0], kc, vc, pos


def lm_verify_window_slots(params: Params, tokens: torch.Tensor,
                           kcaches: torch.Tensor, vcaches: torch.Tensor,
                           poss: torch.Tensor, n_heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Verify windows for S independent streams at per-slot positions (the
    JAX package's vmap of ``lm_verify_window``, written as a slot axis).
    tokens (S, W); caches (S, L·H, max_len, hd), written in place; poss
    (S, 1). Returns (logits (S, W, vocab), kcaches, vcaches, poss + W).
    A slot past capacity NaN-poisons its own rows only."""
    with _full_f32():
        n_layers = stack_shape(params["wqkv"])[0]
        s_ = tokens.shape[0]
        kc, vc = _stream_caches(kcaches, vcaches, s_, n_layers, n_heads)
        logits, p = _verify_window(params, tokens[:, None], kc, vc,
                                   poss.reshape(s_), n_heads)
        return (logits[:, 0], kcaches, vcaches,
                p.reshape(s_, 1).to(torch.int32))


def lm_decode_step_slots(params: Params, tokens: torch.Tensor,
                         kcaches: torch.Tensor, vcaches: torch.Tensor,
                         poss: torch.Tensor, n_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One decode step for S independent streams: tokens (S, 1, 1);
    returns (logits (S, 1, vocab), kcaches, vcaches, poss + 1)."""
    return lm_verify_window_slots(params, tokens[:, :, 0], kcaches, vcaches,
                                  poss, n_heads)


# --------------------------------------------------------------------------- #
# Paged KV cache execution forms (serving/kv_cache.py page pools)
#
# The paged forms do not reimplement attention. Each gathers a slot's pages
# into the flat per-slot cache layout the step forms consume, runs the same
# verify-window body on it, and scatters back only the pages the window
# could have touched. ``page_size`` and the table width B (a slot's view is
# B·page_size tokens, its effective max_len) are static shapes. Every index
# is a device tensor and nothing reads to the host, so the forms run inside
# captured CUDA graphs; the pools are written in place.
# --------------------------------------------------------------------------- #


def paged_view_slots(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Gather S slots' pages into contiguous cache views. pool (n_pages+1,
    L·H, ps, hd); tables (S, B) int page ids. Returns (S, L·H, B·ps, hd): for
    each slot the single-slot transport layout with max_len = B·ps. Table
    rows past a request's allocation hold the null page 0, whose contents
    the causal mask never attends."""
    s_, b = tables.shape
    _, lh, ps, hd = pool.shape
    pages = pool.index_select(0, tables.reshape(-1).long())  # (S·B, LH, ps, hd)
    return pages.view(s_, b, lh, ps, hd).permute(0, 2, 1, 3, 4) \
        .reshape(s_, lh, b * ps, hd)


def _paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One slot's view: table (B,) → (L·H, B·ps, hd)."""
    return paged_view_slots(pool, table[None])[0]


def paged_touch_span(w: int, page_size: int, n_tables: int) -> int:
    """Pages a W-token window can touch at worst alignment (starting at a
    page's last token): (w-1)//ps + 2, capped at the table width. Static:
    the scatter width is part of the program, not data."""
    return min(n_tables, (w - 1) // page_size + 2)


def _writeback_window(views: torch.Tensor, tables: torch.Tensor,
                      p0s: torch.Tensor, nt: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``nt`` pages around each slot's write position ``p0`` in its
    modified view. views (S, L·H, M, hd); tables (S, B); p0s (S,). Returns
    (ids (S, nt), pages (S, nt, L·H, ps, hd)). The start, clip(p0 // ps, 0,
    B − nt), is computed on the device and left-clipped so the window stays
    inside the table; a clipped window rewrites earlier pages with the bits
    they were gathered with, which is harmless and keeps ``nt`` static."""
    s_, lh, m, hd = views.shape
    b = tables.shape[1]
    ps = m // b
    start = torch.clamp(p0s.reshape(s_).long() // ps, 0, b - nt)
    idx = start[:, None] + torch.arange(nt, device=views.device)  # (S, nt)
    ids = torch.gather(tables.long(), 1, idx)
    pages = views.view(s_, lh, b, ps, hd)
    slot = torch.arange(s_, device=views.device)[:, None]
    return ids, pages[slot, :, idx]  # advanced dims lead: (S, nt, LH, ps, hd)


def paged_update_slots(pool: torch.Tensor, views: torch.Tensor,
                       tables: torch.Tensor, p0s: torch.Tensor,
                       nt: int) -> torch.Tensor:
    """Scatter S slots' touched pages back into the pool in one write, in
    place; returns the pool.

    Duplicate scatter indices are harmless by the allocator's invariants:
    modified positions live in pages the slot owns outright (COW), shared
    pages in a clipped window carry their unchanged gathered bits, and empty
    slots' zeroed tables collide only on the null page, which nobody
    attends. Which duplicate's write lands is unordered on the card, so the
    null page's contents are not a result."""
    ids, wins = _writeback_window(views, tables, p0s, nt)
    return pool.index_copy_(0, ids.reshape(-1),
                            wins.reshape((-1,) + wins.shape[2:]))


def _paged_update(pool: torch.Tensor, view: torch.Tensor, table: torch.Tensor,
                  p0: torch.Tensor, nt: int) -> torch.Tensor:
    """Scatter one slot's touched pages back into the pool, in place."""
    return paged_update_slots(pool, view[None], table[None], p0.reshape(1), nt)


def lm_prefill_paged(params: Params, window: torch.Tensor,
                     kpool: torch.Tensor, vpool: torch.Tensor,
                     table: torch.Tensor, pos0: torch.Tensor,
                     true_len: torch.Tensor, n_heads: int,
                     cols: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Prefill a right-padded suffix window directly into pages (the
    prefix-hit admission path): positions 0..pos0-1 already hold valid K/V
    in shared pages, so only the suffix is computed. window (1, Wb) padded
    with ``true_len`` real tokens; table (B,) page ids; pos0 and true_len
    device scalars. The verify-window body's causal rows give the padded-
    prompt masking: logits row true_len − 1 attends columns <= pos0 +
    true_len − 1, never the padded rows' garbage, which a later step
    overwrites before it can be attended.

    ``cols`` (``attend_cols`` of pos0 + Wb, which the caller knows on the
    host) restricts the attention to the columns the window can see, with
    the bits of attending the whole view.

    Returns (logits (1, vocab), kpool, vpool, pos = [pos0 + true_len]),
    the pools written in place."""
    with _full_f32():
        n_layers = stack_shape(params["wqkv"])[0]
        p0 = pos0.reshape(()).long()
        tl = true_len.reshape(()).long()
        kv, vv = _paged_view(kpool, table), _paged_view(vpool, table)
        kc, vc = _stream_caches(kv, vv, 1, n_layers, n_heads)
        logits, _ = _verify_window(params, window[None], kc, vc,
                                   p0.reshape(1), n_heads, cols)
        last = logits[0, 0].index_select(0, (tl - 1).reshape(1))
        nt = paged_touch_span(window.shape[1], kpool.shape[2], table.shape[0])
        _paged_update(kpool, kv, table, p0, nt)
        _paged_update(vpool, vv, table, p0, nt)
        return last, kpool, vpool, (p0 + tl).reshape(1).to(torch.int32)


def lm_verify_window_paged(params: Params, tokens: torch.Tensor,
                           kpool: torch.Tensor, vpool: torch.Tensor,
                           tables: torch.Tensor, poss: torch.Tensor,
                           n_heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Verify windows for S slots against paged caches: gather each slot's
    view, run :func:`lm_verify_window_slots` on the views, scatter back the
    touched pages. tokens (S, W); tables (S, B); poss (S, 1). Returns
    (logits (S, W, vocab), kpool, vpool, poss + W), the pools written in
    place. A slot past its view's capacity B·ps NaN-poisons its own rows."""
    kviews = paged_view_slots(kpool, tables)
    vviews = paged_view_slots(vpool, tables)
    p0s = poss[:, 0].clone()
    logits, _, _, poss2 = lm_verify_window_slots(params, tokens, kviews,
                                                 vviews, poss, n_heads)
    nt = paged_touch_span(tokens.shape[1], kpool.shape[2], tables.shape[1])
    paged_update_slots(kpool, kviews, tables, p0s, nt)
    paged_update_slots(vpool, vviews, tables, p0s, nt)
    return logits, kpool, vpool, poss2


def lm_decode_step_paged(params: Params, tokens: torch.Tensor,
                         kpool: torch.Tensor, vpool: torch.Tensor,
                         tables: torch.Tensor, poss: torch.Tensor,
                         n_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One decode step for S slots against paged caches, the W = 1 case of
    :func:`lm_verify_window_paged`: tokens (S, 1, 1); returns (logits
    (S, 1, vocab), kpool, vpool, poss + 1)."""
    return lm_verify_window_paged(params, tokens[:, :, 0], kpool, vpool,
                                  tables, poss, n_heads)


def prefill_flops(batch: int, seq: int, d_model: int, n_layers: int,
                  vocab: int, d_ff: int = 0) -> float:
    """Analytic forward FLOPs of one prefill (last-token unembed only): per
    token per layer 2·D·3D (QKV) + 2·D² (proj) + 4·D·d_ff (MLP); causal
    attention QKᵀ + PV = 2·D·T·(T+1) per layer per sequence; plus the
    last-token unembed 2·D·V."""
    d_ff = d_ff or 4 * d_model
    dense = 2 * d_model * 3 * d_model + 2 * d_model * d_model \
        + 4 * d_model * d_ff
    attn = 2 * d_model * seq * (seq + 1)
    return float(batch) * (n_layers * (dense * seq + attn)
                           + 2 * d_model * vocab)


def decode_flops(batch: int, pos0: int, n_steps: int, d_model: int,
                 n_layers: int, vocab: int, d_ff: int = 0) -> float:
    """Analytic FLOPs of ``n_steps`` KV-cache decode steps from cache
    position ``pos0`` (step i attends pos0 + i + 1 keys; each step pays
    the dense stack plus one unembed)."""
    d_ff = d_ff or 4 * d_model
    dense = 2 * d_model * 3 * d_model + 2 * d_model * d_model \
        + 4 * d_model * d_ff
    attn = 4 * d_model * (n_steps * (pos0 + 1)
                          + n_steps * (n_steps - 1) // 2)
    return float(batch) * (n_layers * (dense * n_steps + attn)
                           + n_steps * 2 * d_model * vocab)


def empty_cache(n_layers: int, batch: int, n_heads: int, max_len: int,
                head_dim: int, device: Any = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kcache, vcache, pos) zero state in the flat transport layout on
    ``device`` (cuda unless the caller names the CPU)."""
    dev = resolve_device(device)
    flat = (n_layers * batch * n_heads, max_len, head_dim)
    return (torch.zeros(flat, dtype=torch.float32, device=dev),
            torch.zeros(flat, dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def decode_apply(params: Params, n_heads: int, token: torch.Tensor,
                 kcache: torch.Tensor, vcache: torch.Tensor,
                 pos: torch.Tensor):
    """The zoo bundle's function: one decode step on copies of the
    caches, so a pipeline's input buffers are never written."""
    return lm_decode_step(params, token.to(torch.int32), kcache.clone(),
                          vcache.clone(), pos, n_heads)


def prefill_bundle(params: Params, n_heads: int, seq: int, batch: int,
                   flash: bool) -> ModelBundle:
    """The tensor_filter form of prompt scoring (the JAX package's
    ``bench.py`` prefill lane): (B, T) int tokens → (B, vocab) float32
    last-token logits through ``lm_prefill``, whose attention is dense or,
    with ``flash``, one flash kernel launch per layer."""
    vocab = params["embed"].shape[0]

    def apply(tokens):
        logits, _, _, _ = lm_prefill(params, tokens.to(torch.int32), n_heads,
                                     seq, flash=flash)
        return logits.to(torch.float32)

    return ModelBundle(
        "causal_lm_prefill", apply, device=params["embed"].device,
        in_info=TensorsInfo.from_strings(f"{seq}:{batch}", "int32"),
        out_info=TensorsInfo.from_strings(f"{vocab}:{batch}", "float32"))


def make_causal_lm(device: torch.device, vocab: str = "256", dim: str = "64",
                   heads: str = "4", layers: str = "2", max_len: str = "128",
                   batch: str = "1", seed: str = "0", **_: Any) -> ModelBundle:
    from .convert import causal_lm_params

    V, D, H, L = int(vocab), int(dim), int(heads), int(layers)
    M, B = int(max_len), int(batch)
    if D % H:
        raise ValueError(f"causal_lm: dim={D} not divisible by heads={H}")
    hd = D // H
    params = causal_lm_params(init_causal_lm(int(seed), V, D, H, L, M),
                              device)
    flat = L * B * H
    return ModelBundle(
        "causal_lm", lambda *xs: decode_apply(params, H, *xs),
        device=device, params=params,
        apply_params=lambda p, *xs: decode_apply(p, H, *xs),
        in_info=TensorsInfo.from_strings(
            f"1:{B},{hd}:{M}:{flat},{hd}:{M}:{flat},1",
            "int32,float32,float32,int32"),
        out_info=TensorsInfo.from_strings(
            f"{V}:{B},{hd}:{M}:{flat},{hd}:{M}:{flat},1",
            "float32,float32,float32,int32"),
        metadata={"vocab": V, "dim": D, "heads": H, "layers": L,
                  "max_len": M, "head_dim": hd, "batch": B})


register_model("causal_lm", make_causal_lm)
