"""The long-context sequence classifier (``ddp_tpu/models/seq_transformer.py``).

:class:`LongContextTransformer` runs [B, T, d_in] feature sequences
through an embedding Dense, a learned position table sliced at
``pos_offset``, ``depth`` pre-LN encoder blocks (``models/vit.EncoderBlock``),
an fp32 LayerNorm, a mean pool over the tokens and an fp32 head. The
submodules carry the Flax names (``embed``, ``pos_embed``,
``block1.attn.qkv``, ``ln_final``, ``head``), so
``interop/jax_params.seq_transformer_params_{from,to}_jax`` map the trees
name for name.

The JAX model shards tokens over a ``seq`` mesh axis. At a ``seq`` world
of one the attention is :func:`seq_attention`:
``parallel/ring.sequence_sharded_attention``, whose ``"ring"`` is the
hop-0 block through ``flash_attention_with_lse`` and whose ``"ulysses"``
is ``best_attention`` over the full sequence — both B1–B3 (non-causal)
on the card, the plain block on the CPU. Across ranks
(``make_seq_parallel_apply`` :175, ``build_model(..., mesh=)``): each rank
holds a [B, T/n] token slice, its positions from ``seq_rank · T_local``,
the attention runs over the ``seq`` group (the multi-rank ring, or
Ulysses), the blocks are Megatron blocks over ``model``
(``parallel/tp``), and the pool is the mean over the whole sequence, a
sum over ``seq`` (``tp.psum``: an all-reduce forward and backward)
divided by T_global. Every ``seq`` rank then computes the same logits
and loss; :func:`make_seq_parallel_train_step` scales that loss by
1/n_seq, so that summing every gradient over ``seq`` counts the head
once and each token's share once (the pool's backward all-reduce and
the scale are the pair).
:func:`dense_apply` is JAX's single-device reference forward, through
``best_attention``.

:func:`make_seq_parallel_train_step` and
:func:`make_seq_parallel_eval_step` serve every mesh, as JAX's do: on
a data-only one (every axis but the data axis of size one; world 1 is
``runtime/mesh.local_mesh``) the slices, the psum and the scale are the
identity, and the step is data parallelism (the strided microbatches of
JAX's ``reshape(mb, k).swapaxes``, one bucket all-reduce a step,
cross-entropy with label smoothing, device-tensor metrics). Under
``compute_dtype`` bfloat16 the parameters are cast for the forward and
the master weights stay fp32, as JAX's mixed precision; the LayerNorms
and the head compute in fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models.remat import remat_block
from ddp_tpu_torch.models.vit import EncoderBlock, _dense, _layer_norm
from ddp_tpu_torch.parallel.common import check_accum_divisible, precision, xent
from ddp_tpu_torch.parallel.ddp import StepMetrics
from ddp_tpu_torch.parallel.ring import sequence_sharded_attention
from ddp_tpu_torch.parallel.seq_fsdp import (
    gather_fsdp,
    has_fsdp,
    reduce_gradients,
    swapped,
)
from ddp_tpu_torch.parallel.tp import psum, shard_module


class SeqTransformerSpec(NamedTuple):
    num_classes: int
    total_len: int
    d_in: int
    d_model: int = 64
    depth: int = 2
    num_heads: int = 4
    strategy: str = "ring"  # or "ulysses"
    remat: bool = False  # recompute each block in the backward


def seq_attention(strategy: str, comm=None):
    """``(q, k, v) -> out``: the model's attention over the ``seq``
    communicator ``comm`` (None: a world of one), by ``strategy``."""

    def fn(q, k, v):
        return sequence_sharded_attention(q, k, v, strategy=strategy,
                                          comm=comm)

    return fn


class LongContextTransformer(nn.Module):
    """Encoder over [B, T, d_in] feature sequences → fp32 logits."""

    def __init__(self, spec: SeqTransformerSpec, *, attention_fn=None,
                 mlp_ratio: int = 4):
        super().__init__()
        d = spec.d_model
        self.spec = spec
        self.embed = nn.Linear(spec.d_in, d)
        self.pos_embed = nn.Parameter(torch.zeros(1, spec.total_len, d))
        self.block_names = []
        for i in range(spec.depth):
            name = f"block{i + 1}"
            self.add_module(name, EncoderBlock(d, spec.num_heads,
                                               d * mlp_ratio,
                                               attention_fn=attention_fn))
            self.block_names.append(name)
        self.ln_final = nn.LayerNorm(d)
        self.head = nn.Linear(d, spec.num_classes)
        self.mesh = None  # set by build_model(..., mesh=)

    def forward(self, x: torch.Tensor, compute_dtype=None, *,
                pos_offset: int = 0):
        """``x`` [B, T, d_in] → fp32 logits. On a mesh ``x`` is this
        rank's token slice and ``pos_offset`` is its seq rank's."""
        dt = compute_dtype or x.dtype
        T = x.shape[1]
        seq = None if self.mesh is None else self.mesh.comm("seq")
        sharded = seq is not None and seq.size > 1
        if sharded:
            pos_offset = seq.rank * T
        x = _dense(self.embed, x.to(dt), dt)
        x = x + self.pos_embed.to(dt)[:, pos_offset:pos_offset + T]
        remat = self.spec.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x, dt) if remat else block(x, dt)
        x = _layer_norm(self.ln_final, x, dt)  # stays fp32
        if sharded:  # the mean over every rank's tokens
            pooled = psum(x.sum(dim=1), seq) / (T * seq.size)
        else:
            pooled = x.mean(dim=1)
        return F.linear(pooled, self.head.weight.to(dt).float(),
                        self.head.bias.to(dt).float())


def init_seq_transformer(spec: SeqTransformerSpec, *,
                         seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights made with numpy (the scales of the JAX
    initialisers, untruncated): Dense LeCun-normal N(0, 1/fan_in) with
    zero biases, the position table N(0, 0.02²), LayerNorm scale 1 and
    bias 0. No parameter depends on the input length."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in LongContextTransformer(spec).state_dict().items():
        shape = tuple(t.shape)
        if name == "pos_embed":
            v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        elif len(shape) == 2:
            v = (rng.standard_normal(shape, dtype=np.float32)
                 * np.float32(shape[1] ** -0.5))
        elif name.endswith("weight"):  # LayerNorm scale
            v = np.ones(shape, np.float32)
        else:
            v = np.zeros(shape, np.float32)
        state[name] = np.asarray(v, np.float32)
    return state


def build_model(spec: SeqTransformerSpec, state: dict, device, *,
                attention_fn=None, mesh=None) -> LongContextTransformer:
    """The model on ``device`` with ``state`` (numpy or tensors, the FULL
    state) loaded; ``attention_fn`` None: :func:`seq_attention` of
    ``spec.strategy``. ``mesh`` (a ``runtime/mesh.Mesh``): this rank's
    model — the attention over its ``seq`` group, Megatron blocks over
    ``model`` holding this rank's shards (``parallel/tp.shard_module``,
    which leaves the layout in ``model.shard_layout``)."""
    comm = None if mesh is None else mesh.comm("seq")
    model = LongContextTransformer(
        spec, attention_fn=attention_fn or seq_attention(spec.strategy, comm))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    if mesh is not None:
        model.mesh = mesh
        tp = mesh.comm("model")
        if tp.size > 1:
            for name in model.block_names:
                block = getattr(model, name)
                block.tp = block.attn.tp = tp
        shard_module(model, mesh)
    return model.to(device)


def dense_apply(spec: SeqTransformerSpec, state: dict, x: torch.Tensor):
    """The single-device reference forward over the full sequence, through
    ``ops.attention.best_attention`` → fp32 logits."""
    from ddp_tpu_torch.ops.attention import best_attention

    model = build_model(spec, state, x.device, attention_fn=best_attention())
    with torch.no_grad():
        return model.eval()(x)


# ---- across ranks -------------------------------------------------------


def seq_loss_scale(n_seq: int) -> float:
    """The factor on each ``seq`` rank's loss: every rank of a replica
    computes the whole sequence's logits, and the gradients are summed
    over ``seq``."""
    return 1.0 / n_seq


def make_seq_parallel_train_step(state, mesh, *,
                                 compute_dtype=torch.float32,
                                 grad_accum_steps: int = 1,
                                 label_smoothing: float = 0.0):
    """``make_seq_parallel_train_step`` (:285) across ranks →
    ``step(x, labels) -> StepMetrics`` over ``state`` (a
    ``parallel/ddp.TrainState`` of this rank's model and optimizer; the
    step counts in ``state.step``); ``x`` is this data replica's
    [B_local, T_global, d_in] rows (the step takes its ``seq`` columns),
    ``labels`` its [B_local] labels (replicated over ``seq``).

    Each rank's loss is the replica's mean cross-entropy ×
    :func:`seq_loss_scale`; its gradients and the loss and count go
    through one bucket summed over the data axes and ``seq`` and divided
    by the data replicas — never over ``model``, whose replicated leaves
    f/g made whole, and not over ``fsdp`` for the leaves the FSDP
    gather's reduce-scatter summed (``parallel/seq_fsdp``; the forward
    and backward run on the gathered leaves). ``grad_accum_steps=k``:
    strided microbatches (rows ``i::k``). Metrics: the loss, the
    accuracy and the global norm of the full model's gradient."""
    model, optimizer = state.model, state.optimizer
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names, params = [n for n, _ in named], [p for _, p in named]
    layout = model.shard_layout
    n_seq = mesh.shape["seq"]
    scale = seq_loss_scale(n_seq)
    fsdp = has_fsdp(layout)

    def loss_and_correct(x, labels):
        x = mesh.seq_shard(x).to(compute_dtype)
        logits = model(x, compute_dtype=compute_dtype).float()
        loss = xent(logits, labels, label_smoothing).mean() * scale
        correct = (logits.argmax(-1) == labels.long()).sum().float()
        return loss, correct

    def step(x, labels) -> StepMetrics:
        n = labels.shape[0]
        model.train()
        for p in params:
            p.grad = None
        k = grad_accum_steps
        check_accum_divisible(n, k)
        loss = correct = 0.0
        with precision(compute_dtype):
            for i in range(k):
                with swapped(model, gather_fsdp(model, layout, mesh)
                             if fsdp else {}):
                    l_i, c_i = loss_and_correct(x[i::k], labels[i::k])
                    l_i.backward()
                loss, correct = loss + l_i.detach(), correct + c_i
        rest = reduce_gradients(params, names, layout, mesh,
                                [loss / k, correct * scale], accum=k)
        grad_norm = layout.norm([p.grad for p in params])
        optimizer.step()
        state.step += 1
        loss, correct = rest
        return StepMetrics(loss=loss, accuracy=correct / (n * mesh.data_size),
                           grad_norm=grad_norm)

    return step


def make_seq_parallel_eval_step(model: LongContextTransformer, mesh, *,
                                compute_dtype=torch.float32):
    """``step(x, labels, weights) -> (Σ w·correct, Σ w·loss)`` of this
    data replica's rows (``make_seq_parallel_eval_step`` :381), summed
    over the data axes (every ``seq`` and ``model`` rank of a replica
    computes the same logits)."""
    reduce = mesh.comm("data", "fsdp", "expert").all_reduce_
    layout = model.shard_layout
    fsdp = has_fsdp(layout)

    @torch.no_grad()
    def step(x, labels, weights):
        model.eval()
        with precision(compute_dtype), swapped(
                model, gather_fsdp(model, layout, mesh) if fsdp else {}):
            logits = model(mesh.seq_shard(x).to(compute_dtype),
                           compute_dtype=compute_dtype).float()
        w = weights.float()
        out = torch.stack([
            ((logits.argmax(-1) == labels.long()).float() * w).sum(),
            (xent(logits, labels) * w).sum(),
        ])
        reduce(out)
        return out[0], out[1]

    return step
