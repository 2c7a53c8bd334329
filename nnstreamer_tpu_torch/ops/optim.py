"""The trainer's optimizers, written op for op after optax 0.2.6.

``tensor_trainer`` in the JAX package builds ``optax.sgd(lr, momentum=0.9)``,
``optax.adam(lr)`` or ``optax.adamw(lr)`` (nnstreamer_tpu/elements/
trainer.py:77-79) and applies the update with ``optax.apply_updates``. Each
optimizer here runs the same float32 elementwise operations in the same
order as the optax transforms it chains, as plain torch ops (one operation a
kernel, so nothing is fused into a multiply-add on the card):

  * ``trace(decay=0.9)``:          t ← g + 0.9·t;  u ← t
  * ``scale_by_adam(0.9, 0.999, eps=1e-8)``:
        m ← (1 − b1)·g + b1·m;  v ← (1 − b2)·(g·g) + b2·v;  n ← n + 1
        u ← (m / (1 − b1ⁿ)) / (sqrt(v / (1 − b2ⁿ)) + eps)
    (``eps_root`` is 0.0, and v + 0.0 is v for every v ≥ 0);
  * ``add_decayed_weights(1e-4)``: u ← u + 1e-4·p   (adamw only; optax's
    default, not ``torch.optim.AdamW``'s 1e-2);
  * ``scale_by_learning_rate(lr)``: u ← (−lr)·u;
  * ``apply_updates``:             p ← p + u.

The Python constants are rounded to float32 where the tensors meet them, as
JAX rounds its weakly typed scalars. ``b1ⁿ`` is a float32 power of the
step count; XLA's pow and torch's agree on all but a few counts in 10,000,
where they differ in the last bit.

The state has the shape of flax's state dict of the optax state, so a
checkpoint carries across packages unchanged: adam ``{"0": {"count",
"mu", "nu"}, "1": {}}``, adamw the same with ``"2": {}``, sgd ``{"0":
{"trace"}, "1": {}}``. Its moment leaves are whatever ``init`` was given
(the trainer passes one flat float32 tensor of all its masters), and
``update`` changes the parameters and the state in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

OPTIMIZERS = ("sgd", "adam", "adamw")
MOMENTUM = 0.9
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4
INT32_MAX = 2 ** 31 - 1


class Optimizer:
    """One of ``OPTIMIZERS`` at learning rate ``lr``."""

    def __init__(self, name: str, lr: float) -> None:
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r} (known: {', '.join(OPTIMIZERS)})")
        self.name = name
        self.lr = float(lr)

    def init(self, params: torch.Tensor) -> Dict[str, Any]:
        """The state for ``params`` (zero moments, count 0)."""
        if self.name == "sgd":
            return {"0": {"trace": torch.zeros_like(params)}, "1": {}}
        state: Dict[str, Any] = {
            "0": {"count": torch.zeros((), dtype=torch.int32, device=params.device),
                  "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)},
            "1": {}}
        if self.name == "adamw":
            state["2"] = {}
        return state

    @torch.no_grad()
    def update(self, params: torch.Tensor, grads: torch.Tensor,
               state: Dict[str, Any]) -> None:
        """One step: ``params`` and ``state`` are updated in place."""
        if self.name == "sgd":
            trace = state["0"]["trace"]
            trace.copy_(grads + trace * MOMENTUM)
            updates = trace
        else:
            s = state["0"]
            s["mu"].copy_(grads * (1 - B1) + s["mu"] * B1)
            s["nu"].copy_((grads * grads) * (1 - B2) + s["nu"] * B2)
            # optax's safe_increment: the count stops at the int32 maximum
            s["count"].copy_(torch.where(s["count"] < INT32_MAX, s["count"] + 1,
                                         s["count"]))
            count = s["count"].to(torch.float32)
            one = torch.ones((), dtype=torch.float32, device=params.device)
            bc1 = one - torch.pow(torch.full_like(one, B1), count)
            bc2 = one - torch.pow(torch.full_like(one, B2), count)
            updates = (s["mu"] / bc1) / (torch.sqrt(s["nu"] / bc2) + EPS)
            if self.name == "adamw":
                updates = updates + params * WEIGHT_DECAY
        params.copy_(params + updates * (-self.lr))
