"""Sequence parallelism: ring attention and Ulysses over a ``seq`` group.

The PyTorch counterpart of ``ddp_tpu/parallel/ring.py``. The JAX
sequence models send every layer's attention through
``sequence_sharded_attention`` → ``ring_attention`` or
``ulysses_attention`` on [B, T_local, H, D] token shards; on a ``seq``
axis of one rank the ring is its hop-0 block alone. This module ports:

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
- :func:`ring_attention` over a ``seq`` communicator of n ranks
  (``runtime/dist``; None or a group of one: the hop-0 block alone, as
  before). Hop j holds the K/V block of rank (r − j) mod n: hop 0 is the
  diagonal block, causal when the model is; hops 1..n−1 are unmasked
  blocks. Under ``causal`` the strictly-future hops (j > r) skip their
  compute but not their exchange (``ring.py:158-164``). Each hop is one
  block call, merged into an fp32 carry through the (out, lse) combine
  and cast once at the end.
- :func:`ulysses_attention`: one all-to-all trades the sequence shard
  for a head shard ([B, T/n, H, D] → [B, T, H/n, D]; q, k and v in one
  exchange), ``best_attention`` runs over the full sequence, and a
  second all-to-all trades back (``ring.py:175-209``). The heads must
  divide by n.
- :func:`sequence_sharded_attention`, the dispatch between the two.

The multi-rank ring is ONE ``torch.autograd.Function`` (:class:`_Ring`),
whose backward runs the same exchange schedule on every rank whatever
it skips: plain autograd over per-hop send/receive would leave a rank
whose future hops are all skipped (rank 0 under ``causal``) never
running the backward of the exchanges it received, and its neighbour
would wait for it forever. The backward rotates K/V again with fp32
dK/dV accumulators riding along, each live hop running B2 and B3
(:func:`default_block_bwd`) against the MERGED out and lse: with lse the
logsumexp over every key, P = exp(S_block − lse) is the global softmax
restricted to the block, and delta = rowsum(dO∘O) of the merged output,
so the block's dQ and dK/dV are exactly its share of the gradient. After
n shifts the dK/dV are back with their owner. Every shift pairs its send
with its receive (``batch_isend_irecv``), so a ring of 2 cannot block.
"""

from __future__ import annotations

import torch

from ddp_tpu_torch.ops.flash import (
    flash_attention_with_lse,
    flash_dkv,
    flash_dkv_reference,
    flash_dq,
    flash_dq_reference,
    route,
    takes_block,
)
from ddp_tpu_torch.parallel.tp import all_to_all


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


def default_block_bwd(q, k, v, dout, lse, delta, causal: bool):
    """A ring hop's backward against the merged statistics → (dq, dk,
    dv) in q's dtype: B2 then B3 (``ops.flash.flash_dq`` /
    ``flash_dkv``) where :func:`default_block_fn` ran B1, their plain
    versions elsewhere. Nothing is counted as routed here: the hop's
    forward counted it."""
    if route(q.device.type, q.dtype, q.shape[-1]) == "kernel":
        dout = dout.to(q.dtype)
        return (flash_dq(q, k, v, dout, lse, delta, causal),
                *flash_dkv(q, k, v, dout, lse, delta, causal))
    return (flash_dq_reference(q, k, v, dout, lse, delta, causal),
            *flash_dkv_reference(q, k, v, dout, lse, delta, causal))


def _live(hop: int, rank: int, causal: bool) -> bool:
    """Hop ``hop`` of rank ``rank`` holds the block of rank − hop: under
    ``causal`` a block from a later rank (hop > rank) is all masked."""
    return not causal or hop <= rank


class _Ring(torch.autograd.Function):
    """The whole ring, forward and backward, as one Function (the module
    docstring says why)."""

    @staticmethod
    def forward(ctx, q, k, v, comm, causal, block_fn, block_bwd):
        n, r = comm.size, comm.rank
        kv = torch.stack([k, v])
        o = l = None
        for hop in range(n):
            if hop:
                kv = comm.shift(kv)
            if not _live(hop, r, causal):
                continue
            oj, lj = block_fn(q, kv[0], kv[1], causal and hop == 0)
            if o is None:
                o, l = oj.float(), lj
            else:
                o, l = combine_attention_partials(o, l, oj, lj)
        ctx.save_for_backward(q, k, v, o, l)
        ctx.args = comm, causal, block_bwd
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        comm, causal, block_bwd = ctx.args
        n, r = comm.size, comm.rank
        dout = dout.contiguous()
        delta = (dout.float() * o).sum(-1)  # rowsum(dO∘O), fp32 [B, T, H]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for hop in range(n):
            if hop:
                kv = comm.shift(kv)
                dkv = comm.shift(dkv)
            if _live(hop, r, causal):
                dqj, dkj, dvj = block_bwd(q, kv[0], kv[1], dout.to(q.dtype),
                                          lse, delta, causal and hop == 0)
                dq += dqj.float()
                dkv[0] += dkj.float()
                dkv[1] += dvj.float()
        dkv = comm.shift(dkv)  # the n-th shift: home to the owner
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, causal: bool = False, block_fn=None,
                   comm=None, block_bwd=None):
    """Exact attention over the ``seq`` ring of ``comm`` (None or a group
    of one: the hop-0 block alone). q, k, v are this rank's [B, T_local,
    H, D] token shard; the result is in q's dtype, as the JAX ring's is.

    ``block_fn(q, k, v, causal) -> (out, lse)`` defaults to
    :func:`default_block_fn`; over more than one rank ``block_bwd(q, k,
    v, dout, lse, delta, causal) -> (dq, dk, dv)`` (default
    :func:`default_block_bwd`) is each live hop's backward against the
    merged statistics.
    """
    block_fn = block_fn or default_block_fn
    if comm is None or comm.size == 1:
        o, _ = block_fn(q, k, v, causal)
        return o.to(q.dtype)
    return _Ring.apply(q, k, v, comm, causal, block_fn,
                       block_bwd or default_block_bwd)


def ulysses_attention(q, k, v, *, causal: bool = False, comm=None):
    """All-to-all sequence parallelism over ``comm`` (None or a group of
    one: the re-shards are the identity): [B, T/n, H, D] → [B, T, H/n, D]
    for q, k and v in one exchange, ``best_attention`` over the full
    sequence, and back. Raises when n does not divide the heads."""
    from ddp_tpu_torch.ops.attention import best_attention

    fn = best_attention(causal=causal)
    if comm is None or comm.size == 1:
        return fn(q, k, v)
    n, H = comm.size, q.shape[2]
    if H % n:
        raise ValueError(f"{H} heads not divisible by seq axis size {n}")
    qkv = all_to_all(torch.stack([q, k, v]), comm, 3, 2)  # [3, B, T, H/n, D]
    out = fn(qkv[0], qkv[1], qkv[2])
    return all_to_all(out, comm, 1, 2)


def sequence_sharded_attention(q, k, v, *, strategy: str = "ring",
                               causal: bool = False, comm=None,
                               block_fn=None):
    """``strategy`` ∈ {"ring", "ulysses"} over the ``seq`` communicator
    ``comm`` (None: a seq world of one); ``block_fn`` is the ring's (see
    :func:`ring_attention`)."""
    if strategy == "ring":
        return ring_attention(q, k, v, causal=causal, comm=comm,
                              block_fn=block_fn)
    if strategy == "ulysses":
        return ulysses_attention(q, k, v, causal=causal, comm=comm)
    raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
