"""Decoder-only causal language model (dense), as an ``nn.Module``.

The PyTorch counterpart of ``ddp_tpu/models/lm.py``'s dense
``CausalLM``: token embedding → learned position embedding → pre-LN
blocks → final LayerNorm → logits through the TIED embedding
transpose. Parameter names follow the JAX tree (``embed``,
``pos_embed``, ``blockN.{ln1, attn.qkv, attn.proj, ln2, mlp1, mlp2}``,
``ln_final``), so ``interop/jax_params.py`` maps a JAX tree by
transposes alone. Numerics follow Flax: LayerNorm in fp32 with eps
1e-6, tanh-approximated GELU, and the fused qkv columns head-major
``[H, 3, Dh]`` under MHA and group-major ``[H_kv, G+2, Dh]`` under GQA.

MoE blocks, tensor/expert/sequence parallelism and training wait for
later slices; this module serves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.ops.attention import dot_product_attention

LN_EPS = 1e-6  # Flax's LayerNorm default (torch's is 1e-5)


class LMSpec(NamedTuple):
    """The dense subset of ``ddp_tpu.models.lm.LMSpec``."""

    vocab_size: int
    total_len: int
    d_model: int = 64
    depth: int = 2
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → num_heads (MHA)
    mlp_ratio: int = 4

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def derive_lm_spec(state: dict, *, num_heads: int) -> LMSpec:
    """Recover an :class:`LMSpec` from a CausalLM state dict's shapes.

    Everything but the head count shows in the shapes (embed [V, d],
    pos_embed [1, L, d], blockN count, qkv rows (H + 2·H_kv)·Dh, mlp1
    rows); raises ValueError when the head count cannot explain them.
    """
    try:
        vocab_size, d_model = (int(s) for s in state["embed"].shape)
        total_len = int(state["pos_embed"].shape[1])
        qkv_rows = int(state["block1.attn.qkv.weight"].shape[0])
        mlp_dim = int(state["block1.mlp1.weight"].shape[0])
    except (KeyError, IndexError, AttributeError) as e:
        raise ValueError(f"not a causal-LM state (missing {e})") from None
    depth = len({k.split(".")[0] for k in state if k.startswith("block")})
    if d_model % num_heads:
        raise ValueError(
            f"num_heads {num_heads} does not divide d_model {d_model}"
        )
    head_dim = d_model // num_heads
    kv_heads = (qkv_rows // head_dim - num_heads) // 2
    if kv_heads < 1 or (2 * kv_heads + num_heads) * head_dim != qkv_rows:
        raise ValueError(
            f"qkv kernel has {qkv_rows} columns, which no kv-head count "
            f"explains at num_heads {num_heads} — wrong head count?"
        )
    if num_heads % kv_heads or mlp_dim % d_model:
        raise ValueError(
            f"inconsistent shapes: num_heads {num_heads}, kv heads "
            f"{kv_heads}, mlp width {mlp_dim}, d_model {d_model}"
        )
    return LMSpec(
        vocab_size=vocab_size,
        total_len=total_len,
        d_model=d_model,
        depth=depth,
        num_heads=num_heads,
        num_kv_heads=0 if kv_heads == num_heads else kv_heads,
        mlp_ratio=mlp_dim // d_model,
    )


def split_qkv(qkv, H: int, H_kv: int, Dh: int):
    """Fused projection [B, T, (H + 2·H_kv)·Dh] → q [B, T, H, Dh] and
    k/v [B, T, H_kv, Dh], in the JAX package's column order."""
    B, T = qkv.shape[:2]
    if H_kv != H:
        # GQA, GROUP-MAJOR: [kv-group: q·G | k | v] × H_kv.
        G = H // H_kv
        qkv = qkv.reshape(B, T, H_kv, G + 2, Dh)
        return (
            qkv[..., :G, :].reshape(B, T, H, Dh),
            qkv[..., G, :],
            qkv[..., G + 1, :],
        )
    # MHA, HEAD-MAJOR: [head, (q|k|v), head_dim].
    qkv = qkv.reshape(B, T, H, 3, Dh)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


class Attention(nn.Module):
    def __init__(self, spec: LMSpec):
        super().__init__()
        cols = (spec.num_heads + 2 * spec.kv_heads) * spec.head_dim
        self.qkv = nn.Linear(spec.d_model, cols)
        self.proj = nn.Linear(spec.d_model, spec.d_model)


class Block(nn.Module):
    """Pre-LN block. ``qkv`` and ``finish`` are its two halves — the
    counterparts of ``ddp_tpu.models.generate._block_qkv`` (:84) and
    ``_block_finish`` (:150, dense branch) — shared by the dense
    forward, the chunked prefill and the decode step, so the three
    paths cannot drift apart numerically."""

    def __init__(self, spec: LMSpec):
        super().__init__()
        self.spec = spec
        d = spec.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = Attention(spec)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp1 = nn.Linear(d, d * spec.mlp_ratio)
        self.mlp2 = nn.Linear(d * spec.mlp_ratio, d)

    def qkv(self, x):
        """ln1 → fused qkv → (q [B,T,H,Dh], k/v [B,T,H_kv,Dh])."""
        s = self.spec
        return split_qkv(
            self.attn.qkv(self.ln1(x)), s.num_heads, s.kv_heads, s.head_dim
        )

    def finish(self, x, attn_vec):
        """Output projection residual + MLP residual; ``attn_vec`` is
        [B, T, d] (heads concatenated)."""
        x = x + self.attn.proj(attn_vec)
        h = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
        return x + self.mlp2(h)


class CausalLM(nn.Module):
    """[B, T] int tokens → [B, T, vocab] fp32 logits (tied head)."""

    def __init__(self, spec: LMSpec):
        super().__init__()
        self.spec = spec
        self.embed = nn.Parameter(torch.empty(spec.vocab_size, spec.d_model))
        self.pos_embed = nn.Parameter(
            torch.empty(1, spec.total_len, spec.d_model)
        )
        for i in range(spec.depth):
            self.add_module(f"block{i + 1}", Block(spec))
        self.ln_final = nn.LayerNorm(spec.d_model, eps=LN_EPS)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i + 1}") for i in range(self.spec.depth)]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def from_state(cls, spec: LMSpec, state: dict, device=None) -> "CausalLM":
        """Build on ``device`` (the GPU unless ``"cpu"`` is asked for)
        from a state dict of arrays or tensors; inference only."""
        dev = resolve_device(device)
        model = cls(spec)
        model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()},
            strict=True,
        )
        return model.to(dev).requires_grad_(False).eval()

    def head(self, x):
        """Final LayerNorm → tied-embedding logits, fp32."""
        return self.ln_final(x).float() @ self.embed.float().T

    def forward(self, tokens):
        """Dense full-sequence forward — the counterpart of
        ``ddp_tpu.models.lm.dense_lm_apply``."""
        s = self.spec
        T = tokens.shape[1]
        x = self.embed[tokens.long()] + self.pos_embed[:, :T]
        G = s.num_heads // s.kv_heads
        for blk in self.blocks:
            q, k, v = blk.qkv(x)
            attn = dot_product_attention(
                q,
                k.repeat_interleave(G, dim=2),
                v.repeat_interleave(G, dim=2),
                causal=True,
            )
            x = blk.finish(x, attn.reshape(*x.shape))
        return self.head(x)


def init_lm_state(spec: LMSpec, *, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights, made with numpy, as a CausalLM state dict.

    Embeddings draw N(0, 0.02²) and linear weights N(0, 1/fan_in) (the
    scales of Flax's defaults), biases zero, LayerNorms identity.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=f32) * f32(std)).astype(f32)

    d, mlp = spec.d_model, spec.d_model * spec.mlp_ratio
    cols = (spec.num_heads + 2 * spec.kv_heads) * spec.head_dim
    state = {
        "embed": normal((spec.vocab_size, d), 0.02),
        "pos_embed": normal((1, spec.total_len, d), 0.02),
        "ln_final.weight": np.ones(d, f32),
        "ln_final.bias": np.zeros(d, f32),
    }
    for i in range(spec.depth):
        b = f"block{i + 1}."
        for name, (n_out, n_in) in (
            ("attn.qkv", (cols, d)), ("attn.proj", (d, d)),
            ("mlp1", (mlp, d)), ("mlp2", (d, mlp)),
        ):
            state[b + name + ".weight"] = normal((n_out, n_in), n_in**-0.5)
            state[b + name + ".bias"] = np.zeros(n_out, f32)
        for ln in ("ln1", "ln2"):
            state[b + ln + ".weight"] = np.ones(d, f32)
            state[b + ln + ".bias"] = np.zeros(d, f32)
    return state


def init_lm(spec: LMSpec, *, seed: int = 0, device=None) -> CausalLM:
    """A seeded random model on ``device`` (the GPU unless ``"cpu"``)."""
    return CausalLM.from_state(spec, init_lm_state(spec, seed=seed), device)
