"""Ring attention: the one-rank part the training step runs.

The PyTorch counterpart of ``ddp_tpu/parallel/ring.py``. The JAX
causal-LM step sends every layer's attention through
``sequence_sharded_attention`` → ``ring_attention``; on a ``seq`` axis
of one rank that is its hop-0 block alone, ``_default_block_fn``. This
module ports exactly that:

- :func:`_xla_block_with_lse` — the plain per-block attention giving
  ``(out, lse)``, with the JAX block's own causal mask (query t sees keys
  ≤ t, anchored at the top left: the same as the flash kernel's
  end-anchored mask when T == S, which is every block a one-rank ring
  sees).
- :func:`default_block_fn` — the flash kernels B1–B3
  (``ops.flash.flash_attention_with_lse``) on a CUDA tensor of a shape
  they take, at every length, and the plain block elsewhere.
- :func:`combine_attention_partials` — the (out, lse) log-space merge of
  two partial results over disjoint keys; differentiable, so it pins the
  lse gradient of the kernels.
- :func:`ring_attention` at world size 1.

The multi-rank ring and Ulysses over ``torch.distributed`` wait for a
later slice (ROADMAP A3).
"""

from __future__ import annotations

import torch

from ddp_tpu_torch.ops.flash import flash_attention_with_lse, takes_block


def _xla_block_with_lse(q, k, v, causal: bool):
    """Dense per-block attention → (out in q's dtype, lse [B, T, H] fp32);
    fp32 accumulation."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        T, S = logits.shape[-2:]
        mask = (
            torch.arange(T, device=q.device)[:, None]
            >= torch.arange(S, device=q.device)[None, :]
        )
        logits = logits.masked_fill(~mask, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)  # [B, H, T]
    out = torch.einsum(
        "bhts,bshd->bthd", torch.exp(logits - lse[..., None]), v.float()
    )
    return out.to(q.dtype), lse.transpose(1, 2)


def default_block_fn(q, k, v, causal: bool):
    """Per-hop block attention: the flash kernels on a device tensor of a
    shape they take (at every length — the JAX threshold FLASH_MIN_LEN is
    a TPU measurement and is re-measured on the H100 by chip_smoke.py),
    the plain block elsewhere (``ops.flash.takes_block``)."""
    if takes_block(q):
        return flash_attention_with_lse(q, k, v, causal)
    return _xla_block_with_lse(q, k, v, causal)


def combine_attention_partials(o1, l1, o2, l2):
    """Merge two partial attention results over disjoint key sets.

    ``o`` [B, T, H, D], ``l`` (logsumexp rows) [B, T, H]. Softmax over
    K₁∪K₂ is the lse-weighted average of the per-set softmax outputs;
    ``l = -inf`` means "no keys seen". The output stays fp32 (a ring
    carries it across hops; callers cast once at the end).
    """
    m = torch.maximum(l1, l2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w1 = torch.exp(l1 - m_safe)
    w2 = torch.exp(l2 - m_safe)
    denom = w1 + w2
    l_new = torch.where(
        denom > 0.0,
        m_safe + torch.log(torch.clamp(denom, min=1e-30)),
        torch.full_like(denom, -torch.inf),
    )
    norm = torch.clamp(denom, min=1e-30)[..., None]
    o_new = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / norm
    return o_new, l_new


def ring_attention(q, k, v, *, causal: bool = False, block_fn=None):
    """Exact attention over a ``seq`` ring of one rank, where the ring is
    its hop-0 (diagonal) block; the multi-rank ring is ROADMAP A3.

    ``block_fn(q, k, v, causal) -> (out, lse)`` defaults to
    :func:`default_block_fn`. The result is in q's dtype, as the JAX
    ring's is.
    """
    o, _ = (block_fn or default_block_fn)(q, k, v, causal)
    return o.to(q.dtype)
