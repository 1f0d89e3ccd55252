"""Update rules with optax's semantics (``ddp_tpu/train/optim.py:175-225``).

:func:`make_optimizer` builds the chain ``make_optimizer`` builds in the
JAX package, at a constant learning rate, as one in-place updater over
the model's parameters:

- ``sgd``: ``optax.sgd`` (a momentum trace ``t = g + m·t`` when
  momentum is set), after ``add_decayed_weights`` when weight_decay is;
- ``adam``: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0;
  bias-corrected moments, ``m̂ / (√v̂ + eps)``);
- ``adamw``: the Adam direction plus ``weight_decay · p``;
- ``grad_clip_norm``: ``optax.clip_by_global_norm`` first —
  ``g · max_norm / ‖g‖`` only where ``‖g‖ ≥ max_norm``. (torch's
  ``clip_grad_norm_`` adds 1e-6 to the norm, so it is not this rule.)

The updates run as ``torch._foreach_*`` ops on the device with no host
read; the step count is a host integer. Schedules, milestones and EMA
wait for a later slice (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch

from ddp_tpu_torch.parallel.ddp import global_norm

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """An optax-style chain over ``params``, reading ``p.grad``."""

    def __init__(self, params, *, name: str, lr: float, momentum: float,
                 weight_decay: float, grad_clip_norm: float):
        self.params = [p for p in params if p.requires_grad]
        self.name, self.lr, self.momentum = name, lr, momentum
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.trace = zeros() if name == "sgd" and momentum else None
        if name in ("adam", "adamw"):
            self.mu, self.nu = zeros(), zeros()

    def _clip(self, grads) -> None:
        norm = global_norm(grads)
        coef = torch.where(norm < self.grad_clip_norm,
                           torch.ones_like(norm), self.grad_clip_norm / norm)
        torch._foreach_mul_(grads, coef)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a parameter has no gradient: run backward first")
        if self.grad_clip_norm:
            grads = [g.clone() for g in grads]
            self._clip(grads)
        self.count += 1
        if self.name == "sgd":
            if self.weight_decay:
                grads = torch._foreach_add(grads, self.params,
                                           alpha=self.weight_decay)
            if self.trace is not None:
                torch._foreach_mul_(self.trace, self.momentum)
                torch._foreach_add_(self.trace, grads)
                grads = self.trace
            torch._foreach_add_(self.params, grads, alpha=-self.lr)
            return
        # Adam: moments, then bias correction in float32 as optax does it.
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - ADAM_B2)
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** c)
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** c)
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        if self.name == "adamw" and self.weight_decay:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-self.lr)


def make_optimizer(
    params,
    name: str = "sgd",
    *,
    lr: float = 0.01,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    grad_clip_norm: float = 0.0,
) -> Optimizer:
    """The update rule over ``params``, with the JAX package's checks."""
    if name == "adamw" and momentum:
        raise ValueError("momentum is an SGD knob; adamw has betas")
    if name == "adam":
        if weight_decay:
            raise ValueError("adam ignores weight_decay — use adamw")
        if momentum:
            raise ValueError("momentum is an SGD knob; adam has betas")
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(params, name=name, lr=lr, momentum=momentum,
                     weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
