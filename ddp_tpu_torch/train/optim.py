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
moment buffers through checkpoints.

Parameter EMA (``optim.py:20-67``, ``param_ema``): with ``ema_decay``
set, the optimizer keeps ``ema = decay·ema + (1 − decay)·p`` of the
post-update parameters, starting from a copy of the parameters. It lives
in the optimizer's state (:class:`EmaState`), so it checkpoints and
restores with the moments, and it is updated on the device by
``_foreach`` ops after each update, with no host read.
"""

from __future__ import annotations

import numpy as np
import torch

from ddp_tpu_torch.parallel.ddp import global_norm

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_STATE = ("trace", "mu", "nu", "ema")


class EmaState:
    """The exponential moving average of the parameters (not of the
    updates), one fp32 buffer per parameter: ``param_ema``'s state."""

    def __init__(self, params, decay: float):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {decay}")
        self.decay = decay
        # decay and 1 − decay as JAX applies them (a Python float meets an
        # fp32 array as fp32), whatever precision a kernel takes its
        # scalar in.
        self.factors = (float(np.float32(decay)), float(np.float32(1.0 - decay)))
        # A real copy: the EMA must not alias the live parameters.
        self.ema = [p.detach().clone() for p in params]

    @torch.no_grad()
    def update(self, params) -> None:
        """``ema = decay·ema + (1 − decay)·p``, on the device: ``(1 −
        decay)·p`` first, then ``+ decay·ema`` in one multiply-add (XLA's
        order for JAX's update: the same bits on the CPU, one rounding of
        the EMA a step)."""
        new = torch._foreach_mul(list(params), self.factors[1])
        torch._foreach_add_(new, self.ema, alpha=self.factors[0])
        self.ema = new


def param_ema(params, decay: float) -> EmaState:
    """An EMA of ``params``, initialised from them (JAX's
    ``param_ema(decay).init``); raises for a decay outside (0, 1)."""
    return EmaState(params, decay)


def ema_params(optimizer) -> list | None:
    """The EMA buffers of an :class:`Optimizer` (in its parameter
    order), or None without an EMA."""
    state = getattr(optimizer, "ema_state", None)
    return None if state is None else state.ema


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
                 weight_decay: float, grad_clip_norm: float,
                 ema_decay: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.name, self.lr, self.momentum = name, lr, momentum
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.trace = zeros() if name == "sgd" and momentum else None
        if name in ("adam", "adamw"):
            self.mu, self.nu = zeros(), zeros()
        self.ema_state = (param_ema(self.params, ema_decay) if ema_decay
                          else None)
        # The global norm the clip divides by: a sharded model's layout
        # sums its shards' squares over their axes (parallel/tp).
        self.norm = global_norm

    @property
    def ema(self) -> list | None:
        return None if self.ema_state is None else self.ema_state.ema

    def _clip(self, grads) -> None:
        norm = self.norm(grads)
        coef = torch.where(norm < self.grad_clip_norm,
                           torch.ones_like(norm), self.grad_clip_norm / norm)
        torch._foreach_mul_(grads, coef)

    @torch.no_grad()
    def step(self) -> None:
        self._update()
        if self.ema_state is not None:
            self.ema_state.update(self.params)

    def _update(self) -> None:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a parameter has no gradient: run backward first")
        if self.grad_clip_norm:
            grads = [g.clone() for g in grads]
            self._clip(grads)
        self._apply(self.params, grads)

    def _apply(self, params, grads) -> None:
        """One update of the rule on ``params`` in place from ``grads``
        (both lists in the state buffers' order and shapes)."""
        lr = lr_at(self.lr, self.count)
        self.count += 1
        if self.name == "sgd":
            if self.weight_decay:
                grads = torch._foreach_add(grads, params,
                                           alpha=self.weight_decay)
            if self.trace is not None:
                torch._foreach_mul_(self.trace, self.momentum)
                torch._foreach_add_(self.trace, grads)
                grads = self.trace
            torch._foreach_add_(params, grads, alpha=-lr)
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
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)

    @torch.no_grad()
    def reset(self) -> None:
        """A fresh state in place (``--reset_opt_state``): count 0, the
        moments zeroed, the EMA restarted from the current parameters.
        In place, because the train step holds this object."""
        self.count = 0
        for k in ("trace", "mu", "nu"):
            for b in getattr(self, k, None) or []:
                b.zero_()
        if self.ema_state is not None:
            self.ema_state = param_ema(self.params, self.ema_state.decay)

    def state_dict(self, *, copy: bool = True) -> dict:
        """The update count, moment and EMA buffers: CPU copies, or with
        ``copy=False`` the live buffers themselves (detached; the
        asynchronous checkpoint stages those)."""
        out = {"count": self.count}
        for k in _STATE:
            bufs = getattr(self, k, None)
            out[k] = None if bufs is None else [
                b.detach().cpu() if copy else b.detach() for b in bufs]
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place; the buffers it
        holds must match this optimizer's (checked before anything is
        copied)."""
        for k in _STATE:
            mine, theirs = getattr(self, k, None), state.get(k)
            if (mine is None) != (theirs is None) or (
                    mine is not None and len(mine) != len(theirs)):
                raise ValueError(
                    f"optimizer state {k!r} does not match this optimizer "
                    f"({self.name}, momentum {self.momentum}, ema "
                    f"{self.ema_state is not None}): was it saved under "
                    "another --optimizer, --momentum or --ema_decay?")
        for k in _STATE:
            for b, v in zip(getattr(self, k, None) or [], state.get(k) or []):
                b.copy_(v)
        self.count = int(state["count"])


class Zero1Optimizer(Optimizer):
    """``--zero1`` (``spmd.py:143-185``): the rule's state sharded over
    the ``data`` axis while the parameters stay whole. ``layout`` is the
    model's ``parallel/spmd.SpmdLayout`` (its ``state_specs``: each state
    leaf's ZeRO-1 slice of its JAX layout, gathered over its mesh's
    ``data`` axis). A step reads the whole, reduced gradients, clips them
    by their norm, runs the rule on this rank's slice of every leaf
    (parameter, gradient and moments), then all-gathers the updated
    slices into the parameters; a leaf too small to shard updates whole
    on every rank. The EMA (``--ema_decay``) stays whole: evaluation
    reads it as parameters."""

    # A deliberate fault for the controls: "skip_gather" leaves out the
    # parameters' all-gather (a sharded leaf keeps its old value).
    FAULT: str | None = None

    def __init__(self, params, layout, **kw):
        super().__init__(params, **kw)
        self.layout = layout
        self.names = list(layout.names)
        with torch.no_grad():
            for k in ("trace", "mu", "nu"):
                bufs = getattr(self, k, None)
                if bufs is not None:
                    setattr(self, k, [self._slice(n, b).clone()
                                      for n, b in zip(self.names, bufs)])

    def _slice(self, name, t):
        return self.layout.shard_leaf(name, t,
                                      self.layout.state_specs.get(name, ()))

    def _apply(self, params, grads) -> None:
        specs = self.layout.state_specs
        # This rank's slices (copies; a whole leaf is the parameter itself,
        # updated in place).
        own = [self._slice(n, p.detach()).clone() if n in specs
               else p.detach() for n, p in zip(self.names, params)]
        super()._apply(own, [self._slice(n, g) for n, g in zip(self.names,
                                                               grads)])
        if self.FAULT == "skip_gather":
            return
        for n, p, s in zip(self.names, params, own):
            if n in specs:
                p.copy_(self.layout.gather_leaf(n, s, specs[n]))


def check_zero_compatible(name: str, *, grad_clip_norm: float = 0.0,
                          ema_decay: float = 0.0) -> None:
    """Refuse what ``--parallel zero`` cannot run (``optim.py:129-170``):
    the sharded update runs the rule on 1/N flat shards, so it must be
    elementwise — sgd, momentum, adam, adamw, weight decay and the
    schedules are. The parameter EMA is not: it keeps a full-shape
    average that evaluation reads back. ``--grad_clip_norm`` composes:
    the step clips by the norm of the shards, summed over the data group
    (``parallel/zero``), and the optimizer is built without the chained
    clip."""
    del name, grad_clip_norm
    if ema_decay:
        raise ValueError(
            "--ema_decay keeps a full-shape parameter average inside "
            "opt_state, which --parallel zero shards flat — "
            "evaluate-with-EMA could never see whole params; drop one"
        )


def make_optimizer(
    params,
    name: str = "sgd",
    *,
    lr=0.01,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    grad_clip_norm: float = 0.0,
    ema_decay: float = 0.0,
    zero1_layout=None,
) -> Optimizer:
    """The update rule over ``params``, with the JAX package's checks;
    ``lr`` is a float or a :func:`make_schedule` callable;
    ``ema_decay`` > 0 adds the parameter EMA; ``zero1_layout`` (a
    ``parallel/spmd.SpmdLayout`` made with ``zero1=True``) shards its
    state over ``data`` (:class:`Zero1Optimizer`)."""
    if name == "adamw" and momentum:
        raise ValueError("momentum is an SGD knob; adamw has betas")
    if name == "adam":
        if weight_decay:
            raise ValueError("adam ignores weight_decay — use adamw")
        if momentum:
            raise ValueError("momentum is an SGD knob; adam has betas")
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}")
    kw = dict(name=name, lr=lr, momentum=momentum, weight_decay=weight_decay,
              grad_clip_norm=grad_clip_norm, ema_decay=ema_decay)
    if zero1_layout is not None:
        return Zero1Optimizer(params, zero1_layout, **kw)
    return Optimizer(params, **kw)
