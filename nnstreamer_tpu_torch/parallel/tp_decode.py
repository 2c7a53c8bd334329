"""Tensor-parallel (Megatron) KV-cache decode over a mesh axis — port of
nnstreamer_tpu/parallel/tp_decode.py.

The KV cache shards by attention head over ``mesh[axis]``: rank r holds
heads r·H/n … (r+1)·H/n − 1 of every layer, and the columns (q, k, v, the
MLP's up projection) or rows (the attention output and the MLP's down
projection) of the weights that serve them. Activations (B, W, D) are
replicated; each layer sums two partial products over the axis (``psum``,
the Megatron pair) and computes LayerNorm identically on every rank.

Where JAX stacks the per-device slices on a leading device axis, each rank
here holds its own slice: index ``[rank]`` of the JAX ``tp_shard_params``
stacks, bit for bit (``tp_shard_params``). The head-major relayout is the
JAX package's (``_restructure``), and the w8a8 one (``_restructure_w8a8``)
keeps the single-card quantization grids: a column-sharded weight keeps its
codes and per-column scales, a row-sharded one its int8 rows with the
global per-output-channel scales replicated (``wo_s``/``w2_s``), so with
activation grids from the global row absmax and int32 partials summed
exactly (ops/int8.py ``int8_row_sharded_matmul``) every w8a8 GEMM has the
single-card bits.

The step body is the port's batch-invariant verify window
(models/causal_lm.py ``_verify_window``: float64 LayerNorm statistics,
GEMMs in 32-row blocks, attention as products and pairwise-tree sums) over
the rank's local heads, where JAX's TP step uses a plain softmax
(tp_decode.py:258-261). A TP row therefore has the single-card engine's
bits except where float32 partials are summed across ranks (``wo`` and
``w2``; w8a8 sums exact int32 there). Against JAX's TP the logits agree to
float tolerance (the tests state it), as the window prefill does.

Unlike JAX's donated buffers, the caches are written in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.causal_lm import _attend_cache, _full_f32, _ln
from ..ops.int8 import (W8A8_TAG, int8_row_sharded_matmul, is_quantized,
                        matmul_any, stack_shape)
from ..ops.int8 import layer as _layer
from ..ops.kernels.epilogue import gelu_tanh
from .mesh import axis_index, axis_size, mesh_device, psum

__all__ = ["tp_shard_params", "tp_shard_cache", "make_tp_generate",
           "head_major_relayout", "tp_window_step", "tp_token_step",
           "tp_verify_window_slots", "tp_decode_step_slots"]

#: the leaves every rank holds whole (beside w8a8's wo_s/w2_s grids)
_REPL_KEYS = ("embed", "pos_embed", "ln1", "ln2", "lnf")


def _np(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _col_slice(m: np.ndarray, r: int, chunk: int) -> np.ndarray:
    """Rank r's contiguous chunk of the last axis: index [r] of JAX's
    ``_col_shard`` (and ``_scale_shard`` for an (L, N) scale)."""
    return np.ascontiguousarray(m[..., r * chunk:(r + 1) * chunk])


def _row_slice(m: np.ndarray, r: int, chunk: int) -> np.ndarray:
    """Rank r's chunk of the contraction rows of (L, n·chunk, N): index [r]
    of JAX's ``_row_shard``."""
    return np.ascontiguousarray(m[:, r * chunk:(r + 1) * chunk])


def _mlp_chunk(f: int, n: int) -> int:
    if f % n:
        raise ValueError(f"d_ff={f} not divisible by {n} devices")
    return f // n


def _restructure(params: Dict[str, Any], n_heads: int, n: int, r: int
                 ) -> Dict[str, np.ndarray]:
    """Rank r's head-major slices of a float tree."""
    w = _np(params["wqkv"])
    _, d, _ = w.shape
    hc = (n_heads // n) * (d // n_heads)  # columns/rows per rank
    fc = _mlp_chunk(_np(params["w1"]).shape[-1], n)
    return {"wq": _col_slice(w[:, :, :d], r, hc),
            "wk": _col_slice(w[:, :, d:2 * d], r, hc),
            "wv": _col_slice(w[:, :, 2 * d:], r, hc),
            "wo": _row_slice(_np(params["wo"]), r, hc),
            "w1": _col_slice(_np(params["w1"]), r, fc),
            "w2": _row_slice(_np(params["w2"]), r, fc)}


def _restructure_w8a8(qparams: Dict[str, Any], n_heads: int, n: int, r: int
                      ) -> Dict[str, Any]:
    """Rank r's head-major slices of a w8a8 tree, keeping the single-card
    grids: column-sharded weights slice their int8 columns and per-column
    scales; row-sharded ones slice int8 rows and keep the global scales
    (``wo_s``, ``w2_s``) whole."""
    qw, qs = _np(qparams["wqkv"][W8A8_TAG]), _np(qparams["wqkv"]["s"])
    _, d, _ = qw.shape
    hc = (n_heads // n) * (d // n_heads)
    w1q = _np(qparams["w1"][W8A8_TAG])
    fc = _mlp_chunk(w1q.shape[-1], n)
    out: Dict[str, Any] = {}
    for name, w, s in (("wq", qw[:, :, :d], qs[:, :d]),
                       ("wk", qw[:, :, d:2 * d], qs[:, d:2 * d]),
                       ("wv", qw[:, :, 2 * d:], qs[:, 2 * d:])):
        out[name] = {W8A8_TAG: _col_slice(w, r, hc), "s": _col_slice(s, r, hc)}
    out["wo"] = _row_slice(_np(qparams["wo"][W8A8_TAG]), r, hc)
    out["wo_s"] = _np(qparams["wo"]["s"])  # (L, D) global
    out["w1"] = {W8A8_TAG: _col_slice(w1q, r, fc),
                 "s": _col_slice(_np(qparams["w1"]["s"]), r, fc)}
    out["w2"] = _row_slice(_np(qparams["w2"][W8A8_TAG]), r, fc)
    out["w2_s"] = _np(qparams["w2"]["s"])  # (L, D) global
    return out


def _to(a: Any, dev: torch.device) -> Any:
    if isinstance(a, dict):
        return {k: _to(v, dev) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def tp_shard_params(params: Dict[str, Any], n_heads: int, mesh: Any,
                    axis: str = "model") -> Dict[str, Any]:
    """This rank's TP parameter dict on its device: its head-major slices
    of the sharded weights (index [rank] of the JAX stacks), the
    embeddings and norms (and the w8a8 global grids) whole. ``params`` is
    a port tree (tensors on any device) or a JAX tree as numpy."""
    n = axis_size(mesh, axis)
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} not divisible by {n}")
    r = axis_index(mesh, axis)
    sliced = (_restructure_w8a8 if is_quantized(params.get("wqkv"))
              else _restructure)(params, n_heads, n, r)
    dev = mesh_device(mesh)
    out = {k: _to(v, dev) for k, v in sliced.items()}
    for k in _REPL_KEYS:
        out[k] = _to(params[k], dev)
    return out


def head_major_relayout(c: Any, n_layers: int, batch: int, n: int, hn: int):
    """Flat single-device cache (L·B·H, M, hd) → head-major TP layout
    (n, L·B·hn, M, hd); numpy or torch alike."""
    m, hd = c.shape[-2:]
    c = c.reshape(n_layers, batch, n, hn, m, hd)
    c = c.transpose(2, 0, 1, 3, 4, 5) if isinstance(c, np.ndarray) \
        else c.permute(2, 0, 1, 3, 4, 5)
    return c.reshape(n, n_layers * batch * hn, m, hd)


def tp_shard_cache(kcache: Any, vcache: Any, n_layers: int, batch: int,
                   n_heads: int, mesh: Any, axis: str = "model"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slice (L·B·hn, max_len, hd) of a single-device flat
    cache's head-major TP layout: prefill anywhere, decode head-sharded."""
    n = axis_size(mesh, axis)
    r = axis_index(mesh, axis)
    dev = mesh_device(mesh)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(
            head_major_relayout(_np(c), n_layers, batch, n, n_heads // n)[r])
        ).to(dev) for c in (kcache, vcache))


def _tp_window(tp: Dict[str, Any], tokens: torch.Tensor, kc: torch.Tensor,
               vc: torch.Tensor, pos: torch.Tensor, n_heads: int, mesh: Any,
               axis: str, cols: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one TP body: ``causal_lm._verify_window`` over the rank's heads.
    tokens (S, B, W); kc/vc (S, L, B, hn, max_len, hd) views of this rank's
    caches, written in place; pos (S,). Returns (logits (S, B, W, vocab),
    replicated after the sums, and pos + W). Windows past capacity
    NaN-poison their logits."""
    s_, b, w = tokens.shape
    n_layers, hn, max_len = kc.shape[1], kc.shape[3], kc.shape[4]
    d_model = tp["embed"].shape[1]
    hd = d_model // n_heads
    dev = kc.device
    quantized = "wo_s" in tp
    p = pos.reshape(s_).to(torch.int64)
    ar_w = torch.arange(w, device=dev)
    pe = tp["pos_embed"]
    pe_rows = pe[(p.clamp(0, pe.shape[0] - w))[:, None] + ar_w]  # (S, W, D)
    x = tp["embed"][tokens.long()] + pe_rows[:, None]
    cols = max_len if cols is None else cols
    live = (torch.arange(cols, device=dev)[None, None, :]
            <= (p[:, None] + ar_w)[:, :, None])[:, None, None]  # (S,1,1,W,C)
    rows = (p.clamp(0, max_len - w)[:, None] + ar_w)  # (S, W)
    slot = torch.arange(s_, device=dev)[:, None]
    for li in range(n_layers):
        a = _ln(x, tp["ln1"][li])
        q, k, v = (matmul_any(a, _layer(tp[key], li), True)
                   for key in ("wq", "wk", "wv"))  # (S, B, W, hn·hd)
        q = q.reshape(s_, b, w, hn, hd).permute(0, 1, 3, 2, 4)
        kl, vl = kc[:, li], vc[:, li]  # (S, B, hn, M, hd)
        kl.permute(0, 3, 1, 2, 4)[slot, rows] = \
            k.reshape(s_, b, w, hn, hd).permute(0, 2, 1, 3, 4).to(kc.dtype)
        vl.permute(0, 3, 1, 2, 4)[slot, rows] = \
            v.reshape(s_, b, w, hn, hd).permute(0, 2, 1, 3, 4).to(vc.dtype)
        o = _attend_cache(q, kl[..., :cols, :], vl[..., :cols, :], live)
        o = o.permute(0, 1, 3, 2, 4).reshape(s_, b, w, hn * hd)
        # the Megatron pair: the attention output's and the MLP's partial
        # products reduce over the axis (exact int32 under w8a8)
        if quantized:
            x = x + int8_row_sharded_matmul(o, tp["wo"][li], tp["wo_s"][li],
                                            mesh, axis)
            m = _ln(x, tp["ln2"][li])
            h = gelu_tanh(matmul_any(m, _layer(tp["w1"], li)))
            x = x + int8_row_sharded_matmul(h, tp["w2"][li], tp["w2_s"][li],
                                            mesh, axis)
        else:
            x = x + psum(matmul_any(o, tp["wo"][li], True), mesh, axis)
            m = _ln(x, tp["ln2"][li])
            h = gelu_tanh(matmul_any(m, tp["w1"][li], True))
            x = x + psum(matmul_any(h, tp["w2"][li], True), mesh, axis)
    logits = matmul_any(_ln(x, tp["lnf"]), tp["embed"].T, True)
    over = (p + w > max_len).reshape(s_, 1, 1, 1)
    return torch.where(over, torch.nan, logits), p + w


def _slot_views(kcaches: torch.Tensor, vcaches: torch.Tensor, s_: int,
                n_layers: int, hn: int):
    """This rank's flat caches (S·L·B·hn, M, hd) → (S, L, B, hn, M, hd)."""
    m, hd = kcaches.shape[-2:]
    b = kcaches.numel() // (s_ * n_layers * hn * m * hd)
    shape = (s_, n_layers, b, hn, m, hd)
    return kcaches.view(shape), vcaches.view(shape)


def tp_window_step(tp: Dict[str, Any], tokens: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, p: Any, *, n_heads: int, hn: int,
                   max_len: int, mesh: Any, axis: str
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A W-token TP verify window on this rank: tokens (B, W); kc/vc (L, B,
    hn, max_len, hd), written in place; p the write position. Row j attends
    columns <= p + j. Returns (logits (B, W, vocab), kc, vc)."""
    pos = torch.as_tensor(p, device=kc.device).reshape(1).to(torch.int64)
    with _full_f32():
        logits, _ = _tp_window(tp, tokens[None], kc[None], vc[None], pos,
                               n_heads, mesh, axis)
    return logits[0], kc, vc


def tp_token_step(tp: Dict[str, Any], tok: torch.Tensor, kc: torch.Tensor,
                  vc: torch.Tensor, p: Any, *, n_heads: int, hn: int,
                  max_len: int, mesh: Any, axis: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TP decode step, the W = 1 window: tok (B, 1); returns (logits
    (B, vocab), kc, vc)."""
    logits, kc, vc = tp_window_step(tp, tok, kc, vc, p, n_heads=n_heads,
                                    hn=hn, max_len=max_len, mesh=mesh,
                                    axis=axis)
    return logits[:, 0], kc, vc


def tp_verify_window_slots(tp: Dict[str, Any], tokens: torch.Tensor,
                           kcaches: torch.Tensor, vcaches: torch.Tensor,
                           poss: torch.Tensor, n_heads: int, mesh: Any,
                           axis: str = "model"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """``causal_lm.lm_verify_window_slots`` on this rank's heads: tokens
    (S, W); caches (S, L·hn, max_len, hd), written in place; poss (S, 1).
    Returns (logits (S, W, vocab), kcaches, vcaches, poss + W)."""
    with _full_f32():
        n_layers = stack_shape(tp["wq"])[0]
        s_ = tokens.shape[0]
        hn = kcaches.shape[1] // n_layers
        kc, vc = _slot_views(kcaches, vcaches, s_, n_layers, hn)
        logits, p = _tp_window(tp, tokens[:, None], kc, vc, poss.reshape(s_),
                               n_heads, mesh, axis)
        return (logits[:, 0], kcaches, vcaches,
                p.reshape(s_, 1).to(torch.int32))


def tp_decode_step_slots(tp: Dict[str, Any], tokens: torch.Tensor,
                         kcaches: torch.Tensor, vcaches: torch.Tensor,
                         poss: torch.Tensor, n_heads: int, mesh: Any,
                         axis: str = "model"):
    """One TP decode step for S slots: tokens (S, 1, 1); returns (logits
    (S, 1, vocab), kcaches, vcaches, poss + 1)."""
    return tp_verify_window_slots(tp, tokens[:, :, 0], kcaches, vcaches,
                                  poss, n_heads, mesh, axis)


def make_tp_generate(n_heads: int, max_len: int, mesh: Any,
                     axis: str = "model"):
    """A TP greedy generator: (tp_params, first_token (B, 1) int, kc_tp,
    vc_tp (this rank's L·B·hn, max_len, hd), pos (1,), n_steps) → the
    n_steps tokens following first_token, (B, n_steps), the same on every
    rank. The argmax feeds back on the device; the caches are written in
    place. One program per (n_steps, quantized), kept in
    ``generate.compiled``; decoding past capacity raises on the host."""
    n = axis_size(mesh, axis)
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} not divisible by {n}")
    hn = n_heads // n

    def build(n_steps: int):
        def program(tp, tok0, kc, vc, pos):
            n_layers = stack_shape(tp["wq"])[0]
            b = tok0.shape[0]
            kv, vv = _slot_views(kc, vc, 1, n_layers, hn)
            tok = tok0.reshape(b, 1).to(torch.int32)
            p = pos.reshape(1).to(torch.int64)
            toks = []
            for _ in range(n_steps):
                logits, _, _ = tp_token_step(
                    tp, tok, kv[0], vv[0], p, n_heads=n_heads, hn=hn,
                    max_len=max_len, mesh=mesh, axis=axis)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                toks.append(tok[:, 0])
                p = p + 1
            return torch.stack(toks, dim=1)
        return program

    compiled: Dict[Any, Any] = {}

    def generate(tp_params, first_token, kc_tp, vc_tp, pos, n_steps: int):
        # the capacity check on the host: the program can only NaN-poison
        # logits past capacity, which argmax would launder into tokens
        p0 = int(np.asarray(_np(pos)).reshape(-1)[0])
        if p0 + n_steps > max_len:
            raise ValueError(
                f"decode past cache capacity: pos={p0} + n_steps="
                f"{n_steps} > max_len={max_len}")
        key = (n_steps, "wo_s" in tp_params)
        if key not in compiled:
            compiled[key] = build(n_steps)
        dev = kc_tp.device
        with _full_f32():
            return compiled[key](tp_params, torch.as_tensor(
                _np(first_token)).to(dev), kc_tp, vc_tp,
                torch.as_tensor(_np(pos)).to(dev))

    generate.compiled = compiled
    return generate
