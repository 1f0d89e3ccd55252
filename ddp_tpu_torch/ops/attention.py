"""Attention on [B, T, H, D] tensors.

The PyTorch counterpart of ``ddp_tpu/ops/attention.py``:

- ``dot_product_attention`` — plain torch by design (einsum + softmax):
  the chunked-prefill attention of the serving engine and the dense
  causal forward of ``models/lm.CausalLM``.
- ``best_attention`` — the framework's default ``(q, k, v) -> out``:
  the flash kernels B1–B3 (``ops/flash.py``) on a CUDA tensor of a
  shape they take, at every length, ``dot_product_attention`` elsewhere. The JAX package switches
  to its kernel only from ``FLASH_MIN_LEN = 1024`` keys, a TPU v5e
  measurement; chip_smoke.py prints the H100 data for re-measuring it.
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


def best_attention(*, causal: bool = False):
    """Device-resolved default attention → ``(q, k, v) -> out``: the
    flash kernels on a device tensor of a shape they take, the plain path
    elsewhere (``ops.flash.takes_block``)."""

    def fn(q, k, v):
        if takes_block(q):
            return flash_attention(q, k, v, causal)
        return dot_product_attention(q, k, v, causal=causal)

    return fn
