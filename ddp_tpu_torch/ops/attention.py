"""Attention on [B, T, H, D] tensors.

The PyTorch counterpart of ``ddp_tpu/ops/attention.py``:

- ``dot_product_attention`` — plain torch by design (einsum + softmax):
  the chunked-prefill attention of the serving engine and the dense
  causal forward of ``models/lm.CausalLM``.
- ``blockwise_attention`` — plain torch by design: the online softmax
  over key/value blocks, exact, O(T) memory in the key length (the JAX
  function is a ``lax.scan``, not a Pallas kernel).
- ``best_attention`` — the framework's default ``(q, k, v) -> out``:
  the flash kernels B1–B3 (``ops/flash.py``) on a CUDA tensor of a
  shape they take, at every length, ``dot_product_attention`` elsewhere. The JAX package switches
  to its kernel only from ``FLASH_MIN_LEN = 1024`` keys, a TPU v5e
  measurement; chip_smoke.py prints the H100 data for re-measuring it.
- ``gspmd_flash_attention(mesh)`` — the attention of the image family's
  GSPMD blocks (``parallel/spmd``): B1–B3 on this rank's rows (the batch
  over the data axes) and, where the heads divide ``model``, its heads.
  JAX wraps the kernel in a ``shard_map`` island because a Mosaic call
  has no partitioning rule; here the block's activations already ARE
  the rank's shard (its rows, and the column-parallel qkv's heads, or
  every head where they do not divide), so the island is the identity
  on the layout. Every length goes to the kernels on the card, as
  ``best_attention`` does (JAX's ``FLASH_MIN_LEN`` dense cut-off is a
  TPU measurement); the plain path runs only on a CPU tensor, and on
  any other tensor a shape the kernels do not take raises (nothing is
  routed).
"""

from __future__ import annotations

import torch

from ddp_tpu_torch.ops.flash import flash_attention, takes_block

# Large-negative mask value (not -inf): a fully masked row stays finite.
MASK_VALUE = -0.5 * torch.finfo(torch.float32).max


def dot_product_attention(q, k, v, *, causal: bool = False, q_offset=None):
    """Softmax attention, fp32 softmax. [B, T, H, D] in and out.

    ``causal=True`` masks strictly-future keys, END-anchored when
    T != S (query t sees keys up to t + S − T, the KV-cache convention);
    ``q_offset`` overrides the anchor: query t attends keys up to
    ``q_offset + t`` — the masked partial prefill of a chunk whose T
    queries start at absolute position ``q_offset`` in an S-key lane.
    """
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if causal:
        T, S = logits.shape[-2:]
        offset = (S - T) if q_offset is None else q_offset
        mask = (
            torch.arange(T, device=q.device)[:, None] + offset
            >= torch.arange(S, device=q.device)[None, :]
        )
        logits = logits.masked_fill(~mask, MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", weights.to(dtype), v)


def blockwise_attention(q, k, v, *, block_size: int = 512):
    """Softmax attention over [B, T, H, D] by an online softmax over key
    blocks of ``block_size`` (one block when ``S % block_size`` != 0, as
    the JAX function falls back rather than padding with masks). fp32
    accumulation; the result in q's dtype; non-causal."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if S % block_size:
        block_size = S
    qf = q.float()
    scale = D ** -0.5
    acc = q.new_zeros((B, H, T, D), dtype=torch.float32)
    row_max = q.new_full((B, H, T), -torch.inf, dtype=torch.float32)
    row_sum = q.new_zeros((B, H, T), dtype=torch.float32)
    for j in range(0, S, block_size):
        kb = k[:, j:j + block_size].float()
        vb = v[:, j:j + block_size].float()
        logits = torch.einsum("bthd,bshd->bhts", qf, kb) * scale
        new_max = torch.maximum(row_max, logits.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(logits - new_max[..., None])
        acc = acc * correction[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, vb)
        row_sum = row_sum * correction + p.sum(dim=-1)
        row_max = new_max
    out = acc / row_sum[..., None]
    return out.transpose(1, 2).to(q.dtype)


def best_attention(*, causal: bool = False):
    """Device-resolved default attention → ``(q, k, v) -> out``: the
    flash kernels on a device tensor of a shape they take, the plain path
    elsewhere (``ops.flash.takes_block``)."""

    def fn(q, k, v):
        if takes_block(q):
            return flash_attention(q, k, v, causal)
        return dot_product_attention(q, k, v, causal=causal)

    return fn


def gspmd_flash_attention(mesh, *, causal: bool = False):
    """``(q, k, v) -> out`` on this rank's shard of [B, T, H, D] under
    the GSPMD step on ``mesh`` (``ops/attention.py:63``; module
    docstring): B1–B3 on every tensor that is not on the CPU, where a
    shape they do not take raises; the plain path on a CPU tensor."""
    del mesh  # the layout is the block's; nothing to re-shard here

    def fn(q, k, v):
        if q.device.type == "cpu":
            return dot_product_attention(q, k, v, causal=causal)
        return flash_attention(q, k, v, causal)

    return fn
