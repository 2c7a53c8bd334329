"""Token sampling for the serving engine — port of
nnstreamer_tpu/serving/sampling.py.

Temperature, top-k and nucleus (top-p) controls are per-slot tensor
values, so one batch mixes greedy and sampled streams.

Key schedule: a request's random stream depends only on its own seed and
its absolute consumed-token count (``fold_in(seed_key, consumed)``), never
on slot, batch or chunk, so a sampled stream is token-identical to an
isolated run with the same seed. The keys and the draws are the JAX
package's, bit for bit: ``jax.random``'s threefry2x32 (``PRNGKey``,
``fold_in`` and its partitionable random-bits layout, jax 0.9.0's
default) and ``jax.random.categorical``'s path — 32 random bits → a
uniform in [tiny, 1) → Gumbel noise −log(−log u) → argmax of noise +
logits — are written out in integer torch ops (uint32 arithmetic in int64,
masked to 32 bits), so they run on the tensors' own device. Only the two
logs and the softmax/cumsum of the nucleus threshold are floating point:
they can differ from XLA's by an ulp, which changes a draw only when two
candidates tie to within it.

Semantics: ``temperature <= 0`` → greedy argmax; ``top_k <= 0`` disables
top-k (ties at the k-th logit are all kept); ``top_p`` keeps the smallest
prefix of the sorted distribution whose mass reaches p, after top-k;
``top_p >= 1`` or ``<= 0`` disables it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["sample_row", "sample_logits", "seed_key", "step_keys",
           "fold_in", "random_bits"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal, the uniform's lower bound in jax's gumbel
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds), on int64 tensors holding uint32
    values (broadcasting): jax's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def seed_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) key of uint32 values (held in
    int64) — high word 0, low word the seed's low 32 bits. Filled on the
    device: no copy from host memory."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = int(seed) & _M32
    return key


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys (..., 2), data (...)
    integers (taken as uint32) → new keys (..., 2)."""
    d = data.to(torch.int64) & _M32
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def step_keys(seed_keys: torch.Tensor, consumed: torch.Tensor) -> torch.Tensor:
    """Fold each slot's absolute consumed-token count into its seed key:
    seed_keys (S, 2), consumed (S,) → (S, 2)."""
    return fold_in(seed_keys, consumed)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per entry, (S, 2) keys → (S, n) uint32 values in
    int64: jax's partitionable layout, threefry(key, (0, i)) with the two
    output words xor-ed."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return b1 ^ b2


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per key (mode "low"): the top 23
    bits as a mantissa in [1, 2), minus 1, scaled into [tiny, 1), then
    −log(−log u)."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(floats * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """One token per row: logits (S, V), keys (S, 2), controls (S,) →
    (S,) int32. Both filters resolve to one value threshold in sorted
    space, then the categorical draw runs over the original order, so a
    fully disabled call equals ``jax.random.categorical(key, logits/T)``."""
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.to(torch.float32) \
        / torch.clamp(temperature, min=1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    in_k = torch.arange(v, device=logits.device)[None, :] < k_eff[:, None]
    p = torch.softmax(torch.where(in_k, desc, -torch.inf), dim=-1)
    csum = torch.cumsum(p, dim=-1)
    p_disabled = ~((top_p > 0.0) & (top_p < 1.0))
    # keep the minimal prefix whose mass reaches p; a disabled top_p keeps
    # everything explicitly (a saturated float cumsum would clip the tail)
    prefix = ((csum - p) < top_p[:, None]) | p_disabled[:, None]
    vthresh = torch.where(prefix & in_k, desc, torch.inf).amin(dim=-1)
    kept = torch.where(scaled >= vthresh[:, None], scaled, -torch.inf)
    drawn = torch.argmax(gumbel(keys, v) + kept, dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


Control = Union[float, int, torch.Tensor]


def _control(value: Control, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A sampling control as a (1,) tensor: a tensor of one value is
    reshaped where it lies, a Python number filled on the device."""
    if isinstance(value, torch.Tensor):
        return value.reshape(1).to(dtype)
    return torch.full((1,), value, dtype=dtype, device=device)


def sample_row(logits: torch.Tensor, key: torch.Tensor,
               temperature: Control, top_k: Control,
               top_p: Control) -> torch.Tensor:
    """One row of logits (V,) → () int32 (``sample_logits`` of one). The
    key is a (2,) tensor; each control a Python number or a tensor of one
    value on the logits' device (no host round trip either way)."""
    dev = logits.device
    return sample_logits(
        logits[None], key[None], _control(temperature, torch.float32, dev),
        _control(top_k, torch.int32, dev),
        _control(top_p, torch.float32, dev))[0]
