"""The compiled-epoch path of the causal LM (``ddp_tpu/train/fast.py:160-242``).

:func:`make_lm_epoch_runner` keeps the token dataset on the device,
slices each batch from a per-epoch permutation, drives the train step of
``models/lm.make_lm_train_step`` over every batch, and returns the
stacked per-step metrics, still on the device: the caller reads the host
once per epoch. Eager PyTorch has no ``lax.scan`` to fuse the epoch
into one program, so the steps are dispatched from a Python loop
(capturing the step in a CUDA graph is on the ROADMAP).

The permutation source is pluggable: by default a seeded
``torch.Generator`` keyed ``seed + epoch`` (the JAX package's keying);
``permutation=fn(epoch) -> indices`` replaces it. The tests pass JAX's
own plan, ``jax.random.permutation(key(seed + epoch), n)``, because
threefry bits cannot be reproduced in torch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ddp_tpu_torch.models.lm import make_lm_train_step
from ddp_tpu_torch.parallel.ddp import StepMetrics


def default_permutation(n: int, seed: int):
    """``epoch -> randperm(n)`` from a CPU generator seeded ``seed +
    epoch`` (the same plan on every device)."""

    def plan(epoch: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(seed + int(epoch))
        return torch.randperm(n, generator=g)

    return plan


def make_lm_epoch_runner(
    model,
    optimizer,
    tokens: torch.Tensor,
    global_batch_size: int,
    *,
    compute_dtype=torch.float32,
    seed: int = 0,
    grad_accum_steps: int = 1,
    label_smoothing: float = 0.0,
    permutation=None,
):
    """``run(epoch) -> StepMetrics`` of [steps] device tensors.

    ``tokens`` [N, T] int lives on the model's device; the tail that
    does not fill a batch is dropped. ``run.step_seconds`` holds the
    last epoch's per-step times (CUDA events on a GPU, read after the
    epoch's one host sync).
    """
    n = tokens.shape[0]
    steps = n // global_batch_size
    if steps == 0:
        raise ValueError(
            f"dataset of {n} sequences yields zero batches of "
            f"{global_batch_size}"
        )
    tokens = tokens.to(model.device)
    plan = permutation or default_permutation(n, seed)
    step = make_lm_train_step(
        model, optimizer, compute_dtype=compute_dtype,
        grad_accum_steps=grad_accum_steps, label_smoothing=label_smoothing,
    )
    on_gpu = tokens.device.type == "cuda"

    def run(epoch: int) -> StepMetrics:
        perm = torch.as_tensor(np.array(plan(epoch)), dtype=torch.long)
        perm = perm.to(tokens.device, non_blocking=True)
        marks = []
        metrics = []
        for t in range(steps):
            if on_gpu:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            idx = perm[t * global_batch_size:(t + 1) * global_batch_size]
            metrics.append(step(tokens[idx]))
        if on_gpu:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        run.marks = marks
        return StepMetrics(*(
            torch.stack([torch.as_tensor(getattr(m, f)) for m in metrics])
            for f in ("loss", "accuracy", "grad_norm")
        ))

    def step_seconds() -> list[float]:
        """Per-step times of the last epoch (after its host read)."""
        m = run.marks
        if on_gpu:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]

    run.marks = []
    run.step_seconds = step_seconds
    run.steps_per_epoch = steps
    run.step = step
    return run
