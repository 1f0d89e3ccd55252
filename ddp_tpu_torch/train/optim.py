"""Update rules and schedules with optax's semantics
(``ddp_tpu/train/optim.py:72-225``).

:func:`make_optimizer` builds the chain ``make_optimizer`` builds in the
JAX package as one in-place updater over the model's parameters, at a
constant learning rate or one per step from :func:`make_schedule`:

- ``sgd``: ``optax.sgd`` (a momentum trace ``t = g + m·t`` when
  momentum is set), after ``add_decayed_weights`` when weight_decay is;
- ``adam``: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0;
  bias-corrected moments, ``m̂ / (√v̂ + eps)``);
- ``adamw``: the Adam direction plus ``weight_decay · p``;
- ``grad_clip_norm``: ``optax.clip_by_global_norm`` first —
  ``g · max_norm / ‖g‖`` only where ``‖g‖ ≥ max_norm``. (torch's
  ``clip_grad_norm_`` adds 1e-6 to the norm, so it is not this rule.)

The updates run as ``torch._foreach_*`` ops on the device with no host
read; the step count is a host integer, and the learning rate of update
``k`` (from 0) is ``schedule(k)``, as optax's ``scale_by_schedule``
counts. ``state_dict`` / ``load_state_dict`` carry the count and the
moment buffers through checkpoints. Parameter EMA waits (ROADMAP A1).
"""

from __future__ import annotations

import numpy as np
import torch

from ddp_tpu_torch.parallel.ddp import global_norm

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_STATE = ("trace", "mu", "nu")


def make_schedule(
    lr: float,
    *,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    lr_milestones: tuple[int, ...] = (),
    lr_decay_factor: float = 0.1,
):
    """``optim.py:72``: a float, or ``schedule(count) -> lr`` evaluated in
    float32 as optax's schedules are.

    ``decay_steps > 0``: optax's warmup_cosine_decay_schedule (linear
    0 → lr over ``warmup_steps``, then cosine to 0 at ``decay_steps``);
    ``lr_milestones``: lr × ``lr_decay_factor`` per milestone reached
    (count ≥ milestone), after a linear warmup that does not shift them
    (milestones are global step numbers); ``warmup_steps`` alone: the
    linear warmup, then lr.
    """
    if decay_steps > 0 and lr_milestones:
        raise ValueError(
            "decay_steps (cosine) and lr_milestones (staircase) are "
            "mutually exclusive schedules"
        )
    f32 = np.float32
    peak = f32(lr)
    if decay_steps > 0:
        span = decay_steps - warmup_steps
        if span <= 0:
            raise ValueError("decay_steps must exceed warmup_steps")

        def after_warmup(count):  # optax.cosine_decay_schedule(lr, span)
            c = f32(min(count - warmup_steps, span))
            return peak * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span))))
    elif lr_milestones:
        if sorted(lr_milestones) != list(lr_milestones):
            raise ValueError(f"lr_milestones must ascend: {lr_milestones}")

        def after_warmup(count):  # optax.piecewise_constant_schedule
            v = peak
            for m in lr_milestones:
                if count >= m:
                    v = v * f32(lr_decay_factor)
            return v
    elif warmup_steps > 0:
        def after_warmup(count):
            return peak
    else:
        return lr

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule(0, lr, warmup)
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float((f32(0) - peak) * frac + peak)
        return float(after_warmup(count))

    return schedule


def lr_at(schedule, step: int) -> float:
    """A :func:`make_schedule` result at a step (float passthrough)."""
    return float(schedule(step)) if callable(schedule) else float(schedule)


class Optimizer:
    """An optax-style chain over ``params``, reading ``p.grad``; ``lr`` is
    a float or a :func:`make_schedule` callable."""

    def __init__(self, params, *, name: str, lr, momentum: float,
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
        lr = lr_at(self.lr, self.count)
        self.count += 1
        if self.name == "sgd":
            if self.weight_decay:
                grads = torch._foreach_add(grads, self.params,
                                           alpha=self.weight_decay)
            if self.trace is not None:
                torch._foreach_mul_(self.trace, self.momentum)
                torch._foreach_add_(self.trace, grads)
                grads = self.trace
            torch._foreach_add_(self.params, grads, alpha=-lr)
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
        torch._foreach_add_(self.params, updates, alpha=-lr)

    def state_dict(self) -> dict:
        """The update count and moment buffers (CPU copies)."""
        out = {"count": self.count}
        for k in _STATE:
            bufs = getattr(self, k, None)
            out[k] = None if bufs is None else [b.detach().cpu() for b in bufs]
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place; the buffers it
        holds must match this optimizer's."""
        for k in _STATE:
            mine, theirs = getattr(self, k, None), state.get(k)
            if (mine is None) != (theirs is None) or (
                    mine is not None and len(mine) != len(theirs)):
                raise ValueError(
                    f"optimizer state {k!r} does not match this optimizer "
                    f"({self.name}, momentum {self.momentum}): was it "
                    "saved under another --optimizer or --momentum?")
            if mine is not None:
                for b, v in zip(mine, theirs):
                    b.copy_(v)
        self.count = int(state["count"])


def make_optimizer(
    params,
    name: str = "sgd",
    *,
    lr=0.01,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    grad_clip_norm: float = 0.0,
) -> Optimizer:
    """The update rule over ``params``, with the JAX package's checks;
    ``lr`` is a float or a :func:`make_schedule` callable."""
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
