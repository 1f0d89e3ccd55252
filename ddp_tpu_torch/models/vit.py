"""Vision Transformer (``ddp_tpu/models/vit.py``): ViT-Tiny and friends.

Patch-embed (a VALID stride-p conv; patches row-major over (h, w)) →
[cls] + learned position embeddings → pre-LN encoder blocks → LayerNorm
→ an fp32 head on the cls token (or the token mean,
``use_cls_token=False``). The one-rank forms of the JAX modules
(``tp_size = 1``); submodules carry the Flax names (``patch_embed``,
``cls_token``, ``pos_embed``, ``block1.attn.qkv``, ``ln_final``,
``head``), so ``interop/jax_params`` maps the trees name for name.

Attention goes through ``ops/attention.best_attention()``, as the JAX
module's ``fn = self.attention_fn or best_attention()``: on the card the
flash kernels B1–B3 (non-causal) at every length, on q, k and v read in
place as strided views of the fused qkv projection. The fused layout is
head-major, ``[head, (q|k|v), D]``, or group-major under GQA,
``[group, (q_0..q_{G-1}|k|v), D]``.

Where torch's defaults differ from Flax's: LayerNorm eps is 1e-6
(torch's 1e-5) and runs in fp32 (``dtype=jnp.float32``); ``nn.gelu`` is
the tanh approximation (torch's default is exact). Under
``compute_dtype`` the parameters are cast to that dtype, as the JAX
step casts its params; LayerNorm and the head compute in fp32 on them.
``remat`` recomputes each encoder block in the backward
(``models/remat.py``): the forward's attention (B1) runs twice a step.

An encoder block with ``tp`` set (a ``model`` communicator; the
long-context model across ranks) is a Megatron block (``vit.py:36-160``,
``parallel/tp``): its module weights are this rank's shards, qkv and
mlp1 column-parallel behind f, proj and mlp2 row-parallel
(``RowParallelDense``: the partial products summed by g, then the bias).

Under the image family's GSPMD step (``parallel/spmd``) a block has a
``spmd`` plan instead: the ``model`` communicator and which of its
kernels shard over it (JAX's rules, by name and divisibility). Each
product then follows its kernel — :func:`column_dense` (f, then this
rank's output columns, the replicated bias sliced behind f),
:func:`row_dense` (this rank's input features, g, the whole bias) or the
plain product — and an activation sharded over ``model`` is gathered
where the next product wants it whole. Where the heads divide ``model``
this is the Megatron block with replicated biases; where they do not
(ViT-Tiny's 3 heads at ``--mesh_model 2``, qkv 288 of 576 columns a
rank) every rank gathers qkv and runs the attention on all heads, as
JAX's ``head_ax = None``, and feeds its slice of the features into the
row-parallel ``proj``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models.remat import remat_block
from ddp_tpu_torch.ops.attention import best_attention
from ddp_tpu_torch.parallel.tp import (
    gather_replicated,
    megatron_f,
    replicated_chunk,
    row_parallel,
)

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
GELU_APPROXIMATE = "tanh"  # flax.linen.gelu's default (approximate=True)


def _layer_norm(ln: nn.LayerNorm, x, dt):
    """Flax ``nn.LayerNorm(dtype=jnp.float32)`` on parameters cast to
    ``dt``: fp32 in, statistics and output."""
    return F.layer_norm(x.float(), ln.normalized_shape,
                        ln.weight.to(dt).float(), ln.bias.to(dt).float(),
                        LN_EPS)


def _dense(lin: nn.Linear, x, dt):
    return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))


def _row_dense(lin: nn.Linear, x, dt, tp):
    return row_parallel(x, lin.weight.to(dt), lin.bias.to(dt), tp)


def column_dense(lin: nn.Linear, x, dt, plan, name: str):
    """A GSPMD product on a ``model``-replicated ``x`` → (y, whether y is
    sharded over ``model``): column-parallel where the plan shards the
    kernel ``name``, the plain product elsewhere."""
    if name not in plan.sharded:
        return _dense(lin, x, dt), False
    tp = plan.tp
    bias = replicated_chunk(lin.bias, tp, 0)
    return F.linear(megatron_f(x, tp), lin.weight.to(dt), bias.to(dt)), True


def row_dense(lin: nn.Linear, x, dt, plan, name: str, x_sharded: bool):
    """A GSPMD product whose input ``x`` is sharded over ``model`` along
    its features or not → the ``model``-replicated output."""
    tp = plan.tp
    if name not in plan.sharded:
        if x_sharded:
            x = gather_replicated(x, tp, -1)
        return _dense(lin, x, dt)
    if not x_sharded:
        x = replicated_chunk(x, tp, -1)
    return row_parallel(x, lin.weight.to(dt), lin.bias.to(dt), tp)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection → attention → output projection."""

    def __init__(self, dim: int, num_heads: int, *, num_kv_heads: int = 0,
                 attention_fn=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        kv = num_kv_heads or num_heads
        if num_heads % kv:
            raise ValueError(f"num_heads={num_heads} must be a multiple of "
                             f"num_kv_heads={kv}")
        self.num_heads, self.num_kv_heads = num_heads, kv
        self.head_dim = dim // num_heads
        self.attention_fn = attention_fn
        self.qkv = nn.Linear(dim, (num_heads + 2 * kv) * self.head_dim)
        self.proj = nn.Linear(dim, dim)
        self.tp = None  # the ``model`` communicator of a Megatron block
        self.spmd = None  # the GSPMD plan (parallel/spmd.BlockPlan)

    def forward(self, x, dt):
        if self.spmd is not None:
            return self._spmd_forward(x, dt)
        B, T, _ = x.shape
        H, kv, D = self.num_heads, self.num_kv_heads, self.head_dim
        tp = self.tp
        if tp is not None:  # this rank's heads (whole kv groups)
            H, kv = H // tp.size, kv // tp.size
            x = megatron_f(x, tp)
        C = H * D
        fn = self.attention_fn or best_attention()
        qkv = _dense(self.qkv, x, dt)
        if kv == H:  # head-major: [head, (q|k|v), D]
            qkv = qkv.view(B, T, H, 3, D)
            q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        else:  # group-major: [group, (q_0..q_{G-1}|k|v), D]
            g = H // kv
            qkv = qkv.view(B, T, kv, g + 2, D)
            q = qkv[..., :g, :].reshape(B, T, H, D)
            k = qkv[..., g, :].repeat_interleave(g, dim=2)
            v = qkv[..., g + 1, :].repeat_interleave(g, dim=2)
        out = fn(q, k, v)  # [B, T, H, D]
        return _row_dense(self.proj, out.reshape(B, T, C), dt, tp)

    def _spmd_forward(self, x, dt):
        B, T, _ = x.shape
        plan, H, D = self.spmd, self.num_heads, self.head_dim
        qkv, sharded = column_dense(self.qkv, x, dt, plan, "qkv")
        if sharded and H % plan.tp.size:  # heads split mid-head
            qkv, sharded = gather_replicated(qkv, plan.tp, -1), False
        if sharded:
            H //= plan.tp.size
        qkv = qkv.view(B, T, H, 3, D)
        out = self.attention_fn(qkv[:, :, :, 0], qkv[:, :, :, 1],
                                qkv[:, :, :, 2])
        return row_dense(self.proj, out.reshape(B, T, H * D), dt, plan,
                         "proj", sharded)


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp2(gelu(mlp1(ln2(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads: int = 0, attention_fn=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads,
                                       num_kv_heads=num_kv_heads,
                                       attention_fn=attention_fn)
        self.ln2 = nn.LayerNorm(dim)
        self.mlp1 = nn.Linear(dim, mlp_dim)
        self.mlp2 = nn.Linear(mlp_dim, dim)
        self.tp = None  # the ``model`` communicator of a Megatron block
        self.spmd = None  # the GSPMD plan (parallel/spmd.BlockPlan)

    def forward(self, x, dt):
        x = x + self.attn(_layer_norm(self.ln1, x, dt).to(x.dtype), dt)
        y = _layer_norm(self.ln2, x, dt).to(x.dtype)
        if self.spmd is not None:
            y, sharded = column_dense(self.mlp1, y, dt, self.spmd, "mlp1")
            y = F.gelu(y, approximate=GELU_APPROXIMATE)
            return x + row_dense(self.mlp2, y, dt, self.spmd, "mlp2",
                                 sharded)
        if self.tp is not None:
            y = megatron_f(y, self.tp)
        y = F.gelu(_dense(self.mlp1, y, dt), approximate=GELU_APPROXIMATE)
        return x + _row_dense(self.mlp2, y, dt, self.tp)


class ViT(nn.Module):
    """Patch-embed → [cls] + pos-embed → ``depth`` pre-LN blocks → head.
    ``side`` and ``in_channels`` are the input images' (the position
    table has one row a token)."""

    def __init__(self, num_classes: int = 100, patch_size: int = 4,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: int = 4, *, use_cls_token: bool = True,
                 attention_fn=None, side: int = 32, in_channels: int = 3,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        p, d = patch_size, embed_dim
        tokens = (side // p) ** 2 + int(use_cls_token)
        self.patch_size, self.use_cls_token = p, use_cls_token
        self.patch_embed = nn.Conv2d(in_channels, d, p, stride=p)
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d))
        self.block_names = []
        for i in range(depth):
            name = f"block{i + 1}"
            self.add_module(name, EncoderBlock(d, num_heads, d * mlp_ratio,
                                               attention_fn=attention_fn))
            self.block_names.append(name)
        self.ln_final = nn.LayerNorm(d)
        self.head = nn.Linear(d, num_classes)

    def forward(self, x: torch.Tensor, compute_dtype=None, *,
                with_aux: bool = False):
        """``x`` [B, C, H, W] → fp32 logits [B, num_classes]; with
        ``with_aux``, ``(logits, aux)``: the sum of the routed blocks'
        load-balance losses (0 for a model without one)."""
        dt = compute_dtype or x.dtype
        pe = self.patch_embed
        x = F.conv2d(x.to(dt), pe.weight.to(dt), pe.bias.to(dt),
                     stride=self.patch_size)  # VALID
        x = x.flatten(2).transpose(1, 2)  # [B, (h w), d], row-major patches
        if self.use_cls_token:
            cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(dt)
        aux = x.new_zeros((), dtype=torch.float32)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x, dt) if remat else block(x, dt)
            if isinstance(x, tuple):  # a routed block: (x, aux)
                x, a = x
                aux = aux + a
        x = _layer_norm(self.ln_final, x, dt)  # stays fp32
        x = x[:, 0] if self.use_cls_token else x.mean(dim=1)
        logits = F.linear(x, self.head.weight.to(dt).float(),
                          self.head.bias.to(dt).float())
        return (logits, aux) if with_aux else logits

    def init_state(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Seeded random weights made with numpy (the scales of the JAX
        initialisers, untruncated): Dense and the patch conv LeCun-normal
        N(0, 1/fan_in) with zero biases, position table N(0, 0.02²), cls
        token 0, LayerNorm scale 1 and bias 0."""
        rng = np.random.default_rng(seed)
        state = {}
        for name, t in self.state_dict().items():
            shape = tuple(t.shape)
            if name == "pos_embed":
                v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            elif len(shape) >= 2 and name != "cls_token":
                fan_in = int(np.prod(shape[1:]))
                v = (rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(fan_in ** -0.5))
            elif name.endswith("weight"):  # LayerNorm scale
                v = np.ones(shape, np.float32)
            else:
                v = np.zeros(shape, np.float32)
            state[name] = np.asarray(v, np.float32)
        return state


def ViTTiny(num_classes: int = 100, patch_size: int = 4, depth: int = 12,
            **kw) -> ViT:
    """d 192, 3 heads (head dim 64), MLP 768: 5.5 M parameters; at 32×32
    and patch 4, 64 patches + cls = 65 tokens."""
    return ViT(num_classes, patch_size, embed_dim=192, depth=depth,
               num_heads=3, **kw)


def vit_micro(num_classes: int = 10, depth: int = 2, **kw) -> ViT:
    """The JAX registry's smoke config: patch 7, d 32, 4 heads."""
    return ViT(num_classes, patch_size=7, embed_dim=32, depth=depth,
               num_heads=4, **kw)
