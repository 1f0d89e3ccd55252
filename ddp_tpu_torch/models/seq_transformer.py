"""The long-context sequence classifier (``ddp_tpu/models/seq_transformer.py``).

:class:`LongContextTransformer` runs [B, T, d_in] feature sequences
through an embedding Dense, a learned position table sliced at
``pos_offset``, ``depth`` pre-LN encoder blocks (``models/vit.EncoderBlock``),
an fp32 LayerNorm, a mean pool over the tokens and an fp32 head. The
submodules carry the Flax names (``embed``, ``pos_embed``,
``block1.attn.qkv``, ``ln_final``, ``head``), so
``interop/jax_params.seq_transformer_params_{from,to}_jax`` map the trees
name for name.

The JAX model shards tokens over a ``seq`` mesh axis; the port runs a
``seq`` world of one (ROADMAP A2.5 brings more). Its attention is then
:func:`seq_attention`: ``parallel/ring.sequence_sharded_attention``,
whose ``"ring"`` is the hop-0 block through ``flash_attention_with_lse``
and whose ``"ulysses"`` is ``best_attention`` over the full sequence —
both B1–B3 (non-causal) on the card, the plain block on the CPU.
:func:`dense_apply` is JAX's single-device reference forward, through
``best_attention``.

JAX's ``make_seq_parallel_train_step`` and ``make_seq_parallel_eval_step``
at a seq world of one are ``parallel/ddp.make_train_step(...,
strided=True)`` (the strided microbatches of its ``reshape(mb, k)
.swapaxes``; one bucket all-reduce a step over the data-parallel world,
cross-entropy with label smoothing, device-tensor metrics) and
``make_eval_step`` (the weighted ``(correct, loss_sum)``). Under
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
from ddp_tpu_torch.parallel.ring import sequence_sharded_attention


class SeqTransformerSpec(NamedTuple):
    num_classes: int
    total_len: int
    d_in: int
    d_model: int = 64
    depth: int = 2
    num_heads: int = 4
    strategy: str = "ring"  # or "ulysses"
    remat: bool = False  # recompute each block in the backward


def seq_attention(strategy: str):
    """``(q, k, v) -> out``: the model's attention over a ``seq`` world of
    one, by ``strategy``."""

    def fn(q, k, v):
        return sequence_sharded_attention(q, k, v, strategy=strategy)

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

    def forward(self, x: torch.Tensor, compute_dtype=None, *,
                pos_offset: int = 0):
        dt = compute_dtype or x.dtype
        T = x.shape[1]
        x = _dense(self.embed, x.to(dt), dt)
        x = x + self.pos_embed.to(dt)[:, pos_offset:pos_offset + T]
        remat = self.spec.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x, dt) if remat else block(x, dt)
        x = _layer_norm(self.ln_final, x, dt)  # stays fp32
        return F.linear(x.mean(dim=1), self.head.weight.to(dt).float(),
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
                attention_fn=None) -> LongContextTransformer:
    """The model on ``device`` with ``state`` (numpy or tensors) loaded;
    ``attention_fn`` None: :func:`seq_attention` of ``spec.strategy``."""
    model = LongContextTransformer(
        spec, attention_fn=attention_fn or seq_attention(spec.strategy))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(device)


def dense_apply(spec: SeqTransformerSpec, state: dict, x: torch.Tensor):
    """The single-device reference forward over the full sequence, through
    ``ops.attention.best_attention`` → fp32 logits."""
    from ddp_tpu_torch.ops.attention import best_attention

    model = build_model(spec, state, x.device, attention_fn=best_attention())
    with torch.no_grad():
        return model.eval()(x)
