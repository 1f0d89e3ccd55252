"""Pipeline parallelism over the ``pipe`` mesh axis
(``ddp_tpu/parallel/pipeline.py``): one stage a rank, activations and
their cotangents moved point to point.

Every schedule is a timetable (``op``/``mb``/``ck``: [n_slots, S] int
arrays, what each pipe rank does in each slot — :data:`IDLE`, :data:`FWD`
or :data:`BWD` — on which microbatch and which of its local chunks) run
by one executor, :func:`run_timetable`. A slot is one op on every rank,
then the slot's exchanges: a rank whose forward produced an activation
sends it to the next rank (``d + 1 mod S``; chunk c's output feeds chunk
c + 1), a rank whose backward produced a cotangent sends it to the
previous one, and each rank receives what the table says its neighbours
produced in that slot. All of a slot's sends and receives of a rank go
out as one batch (``runtime/dist``'s ``p2p``), so no two ranks can wait
on each other, and a rank that exchanges nothing in a slot calls
nothing. This is JAX's data movement (a ``ppermute`` each way every
slot, the receivers latching from the table) without the ticks that
carry nothing.

The schedules:

- :func:`spmd_pipeline`, GPipe (``pipeline.py:48``): the M forwards
  down the pipe, then the M backwards up it (:func:`schedule_gpipe`,
  2·(M + S − 1) slots). Each microbatch keeps its autograd graph from
  its forward to its backward, which autograd derives, as JAX's AD does;
  the activation memory grows with M.
- ``one_f1b.spmd_pipeline_1f1b`` and
  ``interleaved.spmd_pipeline_interleaved``: the hand-scheduled
  backward. A forward runs without a graph and stashes its chunk's input;
  the backward slot rebuilds the chunk from the stash under
  ``enable_grad`` (stage 0 from the raw microbatch) and applies the
  received cotangent with ``torch.autograd.backward``; the loss runs
  inside the last chunk's backward. The memory does not grow with M.

The stage-0 front (``first_fn``) and the stage S−1 back (``last_fn`` and
the loss) run inside the end chunks, as JAX's non-uniform stages do; the
parameter gradients accumulate in the parameters' ``.grad`` as SUMS over
the microbatches — the step divides them once.

A stage may run collectives of its own inside its op: Megatron's f/g over
``model``, the expert all-to-all over ``expert``, the ring's hops or
Ulysses' all-to-alls over ``seq``. Every member of such a group shares
its pipe coordinate, so they run the same timetable column and issue the
group's collectives in the same order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ddp_tpu_torch.parallel.pipe_common import (
    ENDS_AXES,
    scatter_stage_grads,
    stack_stage_params,
)

__all__ = ["BWD", "FWD", "IDLE", "bubble_fraction", "run_timetable",
           "schedule_gpipe", "spmd_pipeline", "stack_stage_params"]

# A deliberate fault for the controls: "expert_summed" sums an expert
# leaf's gradient over ``expert`` too; "fsdp_unsummed" scatters a stage
# gradient over ``fsdp`` without its sum.
FAULT: str | None = None

IDLE, FWD, BWD = 0, 1, 2
ACT_TAG, COT_TAG = 0, 1  # the activation and cotangent streams' tags


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S−1)/(M+S−1)."""
    S, M = num_stages, num_microbatches
    return (S - 1) / (M + S - 1)


def schedule_gpipe(num_stages: int, num_microbatches: int):
    """GPipe's timetable (op, mb), each [2·(M+S−1), S]: stage d runs the
    forward of microbatch m at slot m + d, then its backward at slot
    (M + S − 1) + (S − 1 − d) + m."""
    S, M = num_stages, num_microbatches
    n = M + S - 1
    op = np.zeros((2 * n, S), np.int32)
    mb = np.zeros((2 * n, S), np.int32)
    for d in range(S):
        for m in range(M):
            op[m + d, d], mb[m + d, d] = FWD, m
            t = n + (S - 1 - d) + m
            op[t, d], mb[t, d] = BWD, m
    return op, mb


def schedule_forward(num_stages: int, num_microbatches: int,
                     virtual_stages: int = 1):
    """A forward-only timetable (op, mb, ck) that walks each microbatch
    through the C = S·v chunks in turn (evaluation: no stash, no
    overlap): slot m·C + c runs chunk c of microbatch m on rank c mod
    S."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    C = S * V
    op = np.zeros((M * C, S), np.int32)
    mb = np.zeros_like(op)
    ck = np.zeros_like(op)
    for m in range(M):
        for c in range(C):
            t, d = m * C + c, c % S
            op[t, d], mb[t, d], ck[t, d] = FWD, m, c // S
    return op, mb, ck


class StageFns:
    """What the executor runs on one rank: ``stage(k, x)`` (local chunk
    ``k`` on activations ``x``), ``first(raw)`` (stage 0's front: the raw
    microbatch → the activation), ``last(y)`` (stage S−1's back) and
    ``loss(out, label) -> (loss_sum, aux_sum)``."""

    def __init__(self, stage: Callable, first: Callable, last: Callable,
                 loss: Callable | None = None):
        self.stage, self.first, self.last, self.loss = stage, first, last, \
            loss


def run_timetable(op, mb, ck, fns: StageFns, *, comm, inputs, labels,
                  act_shape, act_dtype, device, recompute: bool,
                  virtual_stages: int = 1, on_output=None, dropped=()):
    """Run a timetable on this pipe rank (``comm.rank`` = d, ``comm.size``
    = S) → (Σ loss, Σ aux) of the microbatches whose last chunk ran here
    (zeros elsewhere), as fp32 tensors.

    ``inputs[m]``: raw microbatch m (read where chunk 0 runs);
    ``labels[m]``: its labels (read where chunk C−1 runs);
    ``act_shape``/``act_dtype``: the activation every chunk boundary
    carries. ``recompute``: the hand-scheduled backward (stash the
    chunk input, rebuild the chunk in the backward slot); else GPipe's
    (keep each microbatch's graph). ``on_output(m, out)``: a forward-only
    table's hook for the last chunk's output (evaluation). ``dropped``:
    slots whose backward on this rank consumes its inputs and applies
    nothing (a deliberate fault, for the controls).

    The order within a slot: the op, with every collective the stage
    makes over its ``model``, ``expert`` or ``seq`` group, returns
    before the slot's p2p batch over ``pipe`` is posted. A rank that
    posted its exchange first could wait on a neighbour that is still in
    a group collective with a third rank, which waits in turn for this
    one (gloo deadlocks on two groups' operations interleaved in
    different orders on two ranks).
    """
    S, d, V = comm.size, comm.rank, virtual_stages
    C = S * V
    zero = torch.zeros((), dtype=torch.float32, device=device)
    loss_acc, aux_acc = zero.clone(), zero.clone()
    pend_act, pend_cot = {}, {}  # (k, m) → received tensor
    stash, graphs = {}, {}
    for t in range(op.shape[0]):
        my_op, m, k = int(op[t, d]), int(mb[t, d]), int(ck[t, d])
        c = k * S + d
        sends = []
        if my_op == FWD:
            if c == 0:
                with torch.set_grad_enabled(not recompute
                                            and on_output is None):
                    x = fns.first(inputs[m]).to(act_dtype)
            else:
                x = pend_act.pop((k, m))
                if on_output is not None:
                    pass  # the forward alone: nothing to keep
                elif recompute:
                    stash[(k, m)] = x
                else:
                    x = x.requires_grad_(True)
            grad = not recompute and on_output is None
            with torch.set_grad_enabled(grad):
                y = fns.stage(k, x)
                if c == C - 1:
                    if on_output is not None:
                        on_output(m, fns.last(y))
                    elif not recompute:
                        loss, aux = fns.loss(fns.last(y), labels[m])
                        loss_acc += loss.detach().float()
                        aux_acc += torch.as_tensor(aux).detach().float()
                        graphs[(k, m)] = (x, loss)
            if c < C - 1:
                if grad:
                    graphs[(k, m)] = (x, y)
                sends.append(((d + 1) % S, ACT_TAG, y.detach()))
        elif my_op == BWD and t in dropped:
            stash.pop((k, m), None)
            graphs.pop((k, m), None)
            pend_cot.pop((k, m), None)
        elif my_op == BWD:
            if recompute:
                with torch.enable_grad():
                    if c == 0:
                        x = None
                        y = fns.stage(k, fns.first(inputs[m]).to(act_dtype))
                    else:
                        x = stash.pop((k, m)).detach().requires_grad_(True)
                        y = fns.stage(k, x)
                    if c == C - 1:
                        loss, aux = fns.loss(fns.last(y), labels[m])
                        loss_acc += loss.detach().float()
                        aux_acc += torch.as_tensor(aux).detach().float()
                        torch.autograd.backward(loss)
                    else:
                        torch.autograd.backward(y, pend_cot.pop((k, m)))
            else:
                x, y = graphs.pop((k, m))
                if c == C - 1:
                    torch.autograd.backward(y)
                else:
                    torch.autograd.backward(y, pend_cot.pop((k, m)))
            if c > 0:
                sends.append(((d - 1) % S, COT_TAG, x.grad))
        recvs, keys = [], []
        up, down = (d - 1) % S, (d + 1) % S
        if int(op[t, up]) == FWD:
            uk = int(ck[t, up])
            if uk * S + up < C - 1:
                keys.append((pend_act, (uk if d > 0 else uk + 1,
                                        int(mb[t, up]))))
                recvs.append((up, ACT_TAG, act_shape, act_dtype, device))
        if int(op[t, down]) == BWD:
            dk = int(ck[t, down])
            if dk * S + down > 0:
                keys.append((pend_cot, (dk if d < S - 1 else dk - 1,
                                        int(mb[t, down]))))
                recvs.append((down, COT_TAG, act_shape, act_dtype, device))
        if sends or recvs:
            got = comm.p2p(sends, recvs)
            for (buf, key), tensor in zip(keys, got):
                buf[key] = tensor
    if pend_act or pend_cot or stash or graphs:
        raise RuntimeError(
            f"pipe rank {d}: the timetable left {len(pend_act)} "
            f"activation(s), {len(pend_cot)} cotangent(s), {len(stash)} "
            f"stashed input(s) and {len(graphs)} graph(s) unconsumed")
    return loss_acc, aux_acc


def spmd_pipeline(fns: StageFns, *, comm, inputs, labels, act_shape,
                  act_dtype, device):
    """The GPipe step's forward and backward on this pipe rank (``comm``
    the ``pipe`` group's) over the microbatches ``inputs``/``labels`` →
    (Σ loss, Σ aux); the gradients accumulate in the parameters."""
    op, mb = schedule_gpipe(comm.size, len(inputs))
    return run_timetable(op, mb, np.zeros_like(op), fns, comm=comm,
                         inputs=inputs, labels=labels, act_shape=act_shape,
                         act_dtype=act_dtype, device=device, recompute=False)


def pipeline_forward(fns: StageFns, comm, inputs, *, act_shape, act_dtype,
                     device, virtual_stages: int = 1, on_output):
    """The forward alone, each microbatch through the chunks in turn
    (:func:`schedule_forward`); ``on_output(m, out)`` sees the last
    chunk's output, on the rank that holds it."""
    op, mb, ck = schedule_forward(comm.size, len(inputs), virtual_stages)
    run_timetable(op, mb, ck, fns, comm=comm, inputs=inputs, labels=None,
                  act_shape=act_shape, act_dtype=act_dtype, device=device,
                  recompute=True, virtual_stages=virtual_stages,
                  on_output=on_output)


def make_pipe_step(model, optimizer, mesh, *, fns: StageFns, schedule: str,
                   num_microbatches: int, split, act_shape, act_dtype,
                   denom, report_grad_norm: bool):
    """The pipelined train step both families share (the JAX steps'
    ``_apply_update`` and ``_make_handsched_step``): ``step(*batch) ->
    StepMetrics``.

    ``split(*batch)`` → (inputs, labels), the M microbatches;
    ``act_shape(inputs)`` the boundary activation's shape;
    ``denom(*batch)`` the global count the sums are divided by (the
    global batch, or its B·(T−1) targets). The ``fsdp`` leaves are
    gathered once (``layout.gathered``), the timetable of ``schedule``
    (gpipe | 1f1b | interleaved) runs over the ``pipe`` group, and the
    gradients are reduced as ``_make_handsched_lm_step`` reduces them
    (``pipeline_lm.py:638-688``), GPipe's too: the fsdp leaves' are
    reduce-scattered over ``fsdp``; the ends' (the front's, the back's,
    the tied embedding's two parts), the loss and the correct count sum
    over pipe × the batch axes × ``seq`` in one bucket; each stage leaf's
    over ``data`` and ``seq``, over ``expert`` unless the leaf is an
    expert's, and over ``fsdp`` unless it was scattered — a bucket for
    each such group; ``model`` adds nothing (f and g made the sums). All
    are divided by ``denom``; the grad norm is the whole model's
    (``layout.norm``), and the optimizer (its clip by that norm) updates
    every rank's parameters in place.
    """
    from ddp_tpu_torch.parallel.ddp import StepMetrics
    from ddp_tpu_torch.parallel.interleaved import (
        schedule_interleaved,
        spmd_pipeline_interleaved,
    )
    from ddp_tpu_torch.parallel.one_f1b import (
        schedule_1f1b,
        spmd_pipeline_1f1b,
    )

    pipe, ends = mesh.comm("pipe"), mesh.comm(*ENDS_AXES)
    S, M = pipe.size, num_microbatches
    layout = model.shard_layout
    named = list(model.named_parameters())
    end_p = [p for n, p in named if not n.startswith("chunks.")]
    stage_buckets = {}  # the axes a stage leaf's gradient sums over
    for n, p in named:
        if n.startswith("chunks."):
            axes = layout.axes(n)
            if FAULT == "expert_summed":
                axes = axes - {"expert"}
            over = tuple(a for a in ("data", "fsdp", "expert", "seq")
                         if a not in axes)
            stage_buckets.setdefault(over, []).append(p)
    if schedule == "gpipe":
        def run(**kw):
            return spmd_pipeline(fns, **kw)
    elif schedule == "1f1b":
        table = schedule_1f1b(S, M)

        def run(**kw):
            return spmd_pipeline_1f1b(fns, table, **kw)
    elif schedule == "interleaved":
        table = schedule_interleaved(S, M, len(model.chunks))

        def run(**kw):
            return spmd_pipeline_interleaved(fns, table, **kw)
    else:
        raise ValueError(f"unknown pipe schedule {schedule!r}")

    def flat(params):
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])

    def unflat(params, bucket):
        for p, g in zip(params, bucket.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def step(*batch):
        for _, p in named:
            p.grad = None
        inputs, labels = split(*batch)
        with layout.gathered(model) as swaps:
            loss, aux = run(comm=pipe, inputs=inputs, labels=labels,
                            act_shape=act_shape(inputs), act_dtype=act_dtype,
                            device=model.device)
        if swaps:
            scatter_stage_grads(swaps, mesh.comm("fsdp"),
                                summed=FAULT != "fsdp_unsummed")
        n = float(denom(*batch))
        bucket = torch.cat([flat(end_p).float(), loss.reshape(1),
                            aux.reshape(1)])
        ends.all_reduce_(bucket).div_(n)
        unflat(end_p, bucket[:-2])
        for over, params in stage_buckets.items():
            body = mesh.comm(*over).all_reduce_(flat(params).float()).div_(n)
            unflat(params, body)
        grad_norm = (layout.norm([p.grad for _, p in named])
                     if report_grad_norm else None)
        optimizer.step()
        return StepMetrics(loss=bucket[-2].clone(),
                           accuracy=bucket[-1].clone(), grad_norm=grad_norm)

    return step
