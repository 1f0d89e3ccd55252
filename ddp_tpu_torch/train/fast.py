"""The compiled-epoch paths (``ddp_tpu/train/fast.py``): the image models'
:func:`make_epoch_runner` (``fast.py:86-157``) and the causal LM's
:func:`make_lm_epoch_runner` (``fast.py:160-242``).

Each keeps its dataset on the device (images stay uint8), takes one
permutation per epoch, slices every batch from it on the device, drives
the train step over every batch, and returns the stacked per-step
metrics, still on the device: the caller reads the host once per epoch.
Eager PyTorch has no ``lax.scan`` to fuse the epoch into one program, so
the steps are dispatched from a Python loop (:func:`run_steps`, which
the trainer's loader path shares; capturing the step in a CUDA graph is
on the ROADMAP).

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

from ddp_tpu_torch.data.sampler import default_permutation
from ddp_tpu_torch.models.lm import make_lm_train_step
from ddp_tpu_torch.parallel.ddp import StepMetrics, make_train_step
from ddp_tpu_torch.runtime.dist import all_reduce_sum

__all__ = ["default_permutation", "make_epoch_runner", "make_lm_epoch_runner",
           "run_steps", "step_seconds"]


def _mark(on_gpu: bool):
    if not on_gpu:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def run_steps(step, batches, *, on_gpu: bool, between=None):
    """``step(*args)`` over ``batches`` → (StepMetrics of [steps] device
    tensors, or None for no batch; the per-step marks: CUDA events on a
    GPU, host clock readings on the CPU).

    ``between(k) -> stop`` runs on the host before the dispatch of the
    ``k``-th batch (from 0), once that batch exists: the trainer's
    chaos trigger, watchdog beat and preemption check. It must not read
    the device. True stops the loop before that dispatch."""
    marks, metrics = [], []
    batches = iter(batches)
    while True:
        marks.append(_mark(on_gpu))  # the batch's slicing counts as its step's
        args = next(batches, None)
        if args is None or (between is not None and between(len(metrics))):
            break
        metrics.append(step(*args))
    if not metrics:
        return None, marks
    return StepMetrics(*(
        torch.stack([torch.as_tensor(getattr(m, f)) for m in metrics])
        for f in ("loss", "accuracy", "grad_norm")
    )), marks


def step_seconds(marks) -> list[float]:
    """Per-step seconds from :func:`run_steps`'s marks (read them after
    the epoch's host sync)."""
    if marks and isinstance(marks[0], float):
        return [b - a for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def make_epoch_runner(
    state,
    images: torch.Tensor,
    labels: torch.Tensor,
    global_batch_size: int,
    *,
    rank: int = 0,
    world: int = 1,
    reduce=all_reduce_sum,
    compute_dtype=torch.float32,
    seed: int = 0,
    label_smoothing: float = 0.0,
    augment_fn=None,
    permutation=None,
):
    """``run(epoch) -> StepMetrics`` of [steps] device tensors.

    ``images`` [N, H, W, C] uint8 and ``labels`` [N] live on the model's
    device. Batch ``b`` of rank ``r`` is rows ``[b·G + r·local, …)`` of
    the epoch's permutation (``fast.py:133-140``; the loader's strided
    shards differ, and both are the reference's); the tail that does not
    fill a global batch is dropped. The step is
    ``parallel/ddp.make_train_step``'s, one all-reduce each (BatchNorm's
    running statistics in its bucket; ``augment_fn`` on the device).
    ``run.step_seconds()`` gives the last epoch's per-step times.
    """
    if global_batch_size % world:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {world} shards"
        )
    local = global_batch_size // world
    n = images.shape[0]
    steps = n // global_batch_size
    if steps == 0:
        raise ValueError(
            f"dataset of {n} examples yields zero batches of {global_batch_size}"
        )
    plan = permutation or default_permutation(n, seed)
    step = make_train_step(state, world=world, reduce=reduce,
                           compute_dtype=compute_dtype,
                           label_smoothing=label_smoothing,
                           augment_fn=augment_fn, seed=seed, rank=rank)
    offset = rank * local

    def run(epoch: int) -> StepMetrics:
        perm = torch.as_tensor(np.array(plan(epoch)), dtype=torch.long)
        perm = perm.to(images.device, non_blocking=True)

        def batches():
            for t in range(steps):
                idx = perm[t * global_batch_size + offset:][:local]
                yield images[idx], labels[idx]

        metrics, run.marks = run_steps(step, batches(),
                                       on_gpu=images.device.type == "cuda")
        return metrics

    run.marks = []
    run.step_seconds = lambda: step_seconds(run.marks)
    run.steps_per_epoch = steps
    run.step = step
    return run


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
    does not fill a batch is dropped. ``run(epoch, skip_batches,
    between)`` starts at batch ``skip_batches`` of the epoch's plan (a
    preempted epoch's re-entry) and hands ``between`` to
    :func:`run_steps`. ``run.step_seconds`` holds the
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

    def run(epoch: int, skip_batches: int = 0, between=None) -> StepMetrics:
        perm = torch.as_tensor(np.array(plan(epoch)), dtype=torch.long)
        perm = perm.to(tokens.device, non_blocking=True)
        G = global_batch_size
        batches = ((tokens[perm[t * G:(t + 1) * G]],)
                   for t in range(skip_batches, steps))
        metrics, run.marks = run_steps(step, batches,
                                       on_gpu=tokens.device.type == "cuda",
                                       between=between)
        return metrics

    run.marks = []
    run.step_seconds = lambda: step_seconds(run.marks)
    run.steps_per_epoch = steps
    run.step = step
    return run
