"""Slot-level decode primitives for continuous-batching serving.

The PyTorch counterpart of the fixed-lane half of
``ddp_tpu/models/generate.py``. The serving engine keeps ONE decode
batch of S slots alive; requests of different ages share it:

- :class:`SlotCache` — per-layer K/V lanes [depth, S, total_len, H_kv,
  Dh] (fp32, or int8 with per-(position, head) fp32 scales) and the
  per-slot position ``pos`` [S] int32. Unlike JAX's immutable arrays,
  the port updates the cache IN PLACE (one buffer, no donation needed).
- :func:`slot_decode_step` — every lane advances one token at its own
  position; the attention is ``ops/decode.decode_attention`` (the CUDA
  flash-decode kernel on the GPU). ``pos`` stays on the device: the
  step never reads a value back to the host.
- :func:`prefill_chunk` — one chunk of a prompt written into one lane
  (Sarathi-style chunked prefill), plain-torch attention; a host-int
  wrapper of :func:`prefill_chunk_device`, the same over 0-dim device
  scalars (no host branch, no upload: what a CUDA graph captures).
- :class:`PagedSlotCache` — the paged layout (``serve/pages.py``): K/V
  in a pool of ``page_size``-token pages, each lane's positions spelled
  by its row of an int32 page table, so lanes whose prompts share a
  prefix map the same pages. Both :func:`slot_decode_step` (through
  ``ops/decode.paged_decode_attention``: the paged CUDA kernel on the
  GPU) and :func:`prefill_chunk` take either cache.
- :func:`slot_verify_step` — speculative decoding's verify: K draft
  tokens per lane scored in ONE target step (plain-torch attention over
  :func:`_full_kv`, as the JAX package computes it outside any Pallas
  kernel), sampled by :func:`sample_slot_tokens_block` at the counters
  the non-speculative loop would use, so the accepted prefix is exactly
  that loop's stream.
- Seeded sampling by Gumbel-max from a counter-based generator keyed by
  (seed, emitted-token index, vocab id), in torch integer ops on the
  device, with no ``torch.Generator`` per lane. A seeded stream thus
  depends only on its own seed and step, as the JAX engine's
  ``fold_in(key(seed), step)`` stream does — but the bits differ from
  JAX's threefry, so seeded streams are held to the sampling invariants
  and greedy streams to token identity.

Every step's block ends in ``models/lm.Block.finish``, the counterpart
of JAX's ``_block_finish`` (:150): a routed block of an MoE model takes
the serving expert MLP there, ``MoEMLP.serve`` (``generate.py:107-147``'s
``_moe_mlp``: no capacity, the spec's top-k and gate normalisation, a
dense E-way FFN), per token and of static shape, so decode, prefill
chunks and the verify step all run it and a CUDA graph captures it.

Idle lanes are decoded too (the batch shape never changes); position 0
is always live, so their outputs are finite garbage the engine ignores.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ddp_tpu_torch.models.lm import CausalLM, LMSpec
from ddp_tpu_torch.ops.attention import dot_product_attention
from ddp_tpu_torch.ops.decode import (
    decode_attention,
    dequantize_kv,
    gather_paged_kv,
    paged_decode_attention,
    quantize_kv,
)
from ddp_tpu_torch.utils.counter_rng import M32 as _M32
from ddp_tpu_torch.utils.counter_rng import mix32 as _mix32


@dataclass
class SlotCache:
    """Fixed-lane KV cache; ``k_scale``/``v_scale`` ([depth, S, L,
    H_kv] fp32) exist only for int8 caches."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def lane_scales(self, layer: int):
        """Per-layer (k_scale, v_scale), (None, None) on fp32 caches."""
        if self.quantized():
            return self.k_scale[layer], self.v_scale[layer]
        return None, None

    def nbytes(self) -> int:
        parts = [self.k, self.v]
        if self.quantized():
            parts += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in parts)


def init_slot_cache(
    spec: LMSpec, slots: int, *, dtype=torch.float32, device
) -> SlotCache:
    """Zeroed cache; ``dtype=torch.int8`` adds the per-head scales."""
    shape = (spec.depth, slots, spec.total_len, spec.kv_heads, spec.head_dim)
    quant = dtype == torch.int8
    return SlotCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros(slots, dtype=torch.int32, device=device),
        k_scale=(
            torch.zeros(shape[:-1], device=device) if quant else None
        ),
        v_scale=(
            torch.zeros(shape[:-1], device=device) if quant else None
        ),
    )


@dataclass
class PagedSlotCache:
    """Paged variant of :class:`SlotCache` (``ddp_tpu/models/generate.py``
    ``PagedSlotCache``): ``k``/``v`` [depth, num_pages, page_size, H_kv,
    Dh], int8 scales [depth, num_pages, page_size, H_kv]; ``table`` [S,
    lane_pages] int32 page ids on the device (lane_pages = total_len /
    page_size) and ``pos`` [S] as in SlotCache.

    Page 0 is the engine's SCRATCH page: all-zero table rows (idle
    lanes) read and write it, and writes at or past a lane's table end
    land in it (JAX drops them; torch's indexed writes have no drop
    mode, and page 0 is never attended at a live position, so routing
    them there is the same to every live lane).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    quantized = SlotCache.quantized
    lane_scales = SlotCache.lane_scales
    nbytes = SlotCache.nbytes

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def init_paged_slot_cache(
    spec: LMSpec, slots: int, *, num_pages: int, page_size: int,
    dtype=torch.float32, device,
) -> PagedSlotCache:
    """A zeroed pool and all-zero (scratch-mapped) tables; the pool holds
    ``num_pages · page_size`` cache lines whatever ``slots`` is."""
    if spec.total_len % page_size:
        raise ValueError(
            f"page_size {page_size} must divide total_len {spec.total_len}"
        )
    shape = (spec.depth, num_pages, page_size, spec.kv_heads, spec.head_dim)
    quant = dtype == torch.int8
    return PagedSlotCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros(slots, dtype=torch.int32, device=device),
        table=torch.zeros(slots, spec.total_len // page_size,
                          dtype=torch.int32, device=device),
        k_scale=torch.zeros(shape[:-1], device=device) if quant else None,
        v_scale=torch.zeros(shape[:-1], device=device) if quant else None,
    )


def _page_scatter_ids(table, posns, page_size: int):
    """Absolute positions → (page ids, in-page offsets) for writes, both
    int64 and shaped like ``posns``. ``table``: [..., lane_pages] int32
    rows with the leading dims of ``posns`` (a decode step passes the
    whole table with [S, T] positions, a chunk one lane's row with [C]).
    Positions at or past the table's end map to the scratch page 0, on
    the device (no host sync)."""
    lane_pages = table.shape[-1]
    pidx = torch.clamp(posns // page_size, max=lane_pages - 1)
    pids = torch.gather(table.long(), -1, pidx)
    pids = torch.where(posns < lane_pages * page_size, pids,
                       torch.zeros_like(pids))
    return pids, posns % page_size


def _write_pages(cache: PagedSlotCache, layer: int, pids, offs, k, v):
    """Rows ``k``/``v`` [..., H_kv, Dh] into the pool at (pids, offs) of
    :func:`_page_scatter_ids`, in place, quantized on an int8 pool (the
    paged row write of JAX's ``_paged_write_rows``; the callers compute
    the ids once, outside the layer loop)."""
    if cache.quantized():
        qk, ks = quantize_kv(k)
        qv, vs = quantize_kv(v)
        cache.k_scale[layer][pids, offs] = ks
        cache.v_scale[layer][pids, offs] = vs
        k, v = qk, qv
    cache.k[layer][pids, offs] = k.to(cache.k.dtype)
    cache.v[layer][pids, offs] = v.to(cache.v.dtype)


def _write_kv_rows(cache: SlotCache, layer: int, k, v, pos) -> None:
    """Write each lane's T rows [S, T, H_kv, Dh] at ``pos[s]``, in place.

    The start clamps at ``L - T`` per lane, as JAX's
    ``dynamic_update_slice`` does: an idle lane parked at the position
    ceiling writes the last line, which a refill overwrites. On an int8
    cache the rows quantize on write.
    """
    S, T = k.shape[:2]
    L = cache.k.shape[2]
    start = torch.clamp(pos.long(), max=L - T)
    idx = start[:, None] + torch.arange(T, device=k.device)[None, :]
    lanes = torch.arange(S, device=k.device)[:, None]
    if cache.quantized():
        qk, ks = quantize_kv(k)
        qv, vs = quantize_kv(v)
        cache.k[layer][lanes, idx] = qk
        cache.v[layer][lanes, idx] = qv
        cache.k_scale[layer][lanes, idx] = ks
        cache.v_scale[layer][lanes, idx] = vs
    else:
        cache.k[layer][lanes, idx] = k.to(cache.k.dtype)
        cache.v[layer][lanes, idx] = v.to(cache.v.dtype)


def _full_kv(cache, layer: int):
    """All S lanes' [S, L, H_kv, Dh] fp32 views of ``layer`` —
    dequantized if int8, gathered through the tables if paged (JAX's
    ``_full_kv``): the verify step's key/value source."""
    kf, vf = cache.k[layer], cache.v[layer]
    ksc, vsc = cache.lane_scales(layer)
    if isinstance(cache, PagedSlotCache):
        kf = gather_paged_kv(kf, cache.table)
        vf = gather_paged_kv(vf, cache.table)
        if ksc is not None:
            ksc = gather_paged_kv(ksc, cache.table)
            vsc = gather_paged_kv(vsc, cache.table)
    if ksc is not None:
        return dequantize_kv(kf, ksc), dequantize_kv(vf, vsc)
    return kf.float(), vf.float()


@torch.no_grad()
def slot_decode_step(
    model: CausalLM, cache: SlotCache, tokens, *, attn_impl: str = "reference"
):
    """Feed ``tokens`` [S] (slot s's token at ``cache.pos[s]``) →
    logits [S, vocab] fp32; the cache and ``pos`` advance in place.

    ``pos`` clamps at ``total_len`` so an idle slot can sit in the batch
    indefinitely; the position embedding reads ``pos_embed[min(pos,
    L-1)]``. ``attn_impl`` picks the decode attention (``reference`` the
    plain version, ``flash``/``auto`` the CUDA kernel on the GPU). On a
    :class:`PagedSlotCache` the rows scatter through the page table and
    the attention reads the pool through it
    (``ops/decode.paged_decode_attention``).
    """
    spec = model.spec
    L = spec.total_len
    S = tokens.shape[0]
    pos = cache.pos
    x = model.embed[tokens.long()][:, None, :]  # [S, 1, d]
    pe = model.pos_embed[0]
    x = x + pe[torch.clamp(pos, max=L - 1).long()][:, None, :]
    paged = isinstance(cache, PagedSlotCache)
    if paged:  # each lane's row lands at pos[s] through its table
        pids, offs = _page_scatter_ids(cache.table, pos.long()[:, None],
                                       cache.page_size)
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv(x)
        ksc, vsc = cache.lane_scales(i)
        if paged:
            _write_pages(cache, i, pids, offs, k, v)
            attn = paged_decode_attention(
                q[:, 0], cache.k[i], cache.v[i], cache.table, pos, ksc, vsc,
                impl=attn_impl,
            )
        else:
            _write_kv_rows(cache, i, k, v, pos)
            attn = decode_attention(
                q[:, 0], cache.k[i], cache.v[i], pos, ksc, vsc,
                impl=attn_impl,
            )  # [S, H, Dh] fp32
        x = blk.finish(x, attn.reshape(S, 1, spec.d_model).to(x.dtype))
    logits = model.head(x[:, 0])
    pos.add_(1).clamp_(max=L)
    return logits


# ---- sampling ---------------------------------------------------------


def gumbel_noise(seeds, steps, vocab: int):
    """Standard Gumbel noise [S, vocab] fp32 from a counter-based
    generator keyed by (seed, step, vocab id): lane s's noise depends
    on (seeds[s], steps[s]) alone, never on the other lanes."""
    key = _mix32(_mix32(seeds.long() & _M32) ^ (steps.long() & _M32))
    ctr = _mix32(torch.arange(vocab, device=seeds.device, dtype=torch.int64))
    h = _mix32(_mix32(key[:, None] ^ ctr[None, :]) ^ key[:, None])
    u = ((h >> 8).float() + 0.5) * (2.0**-24)  # in (0, 1)
    return -torch.log(-torch.log(u))


def nucleus_filter(logits, top_p):
    """Keep the smallest probability-sorted prefix of each row whose
    mass reaches ``top_p`` (the best token always survives); the rest
    become a large negative. ``logits`` [..., V], ``top_p`` [...] or a
    float. Semantics of ``ddp_tpu.models.generate.nucleus_filter``."""
    logits = logits.float()
    neg = torch.finfo(torch.float32).min / 2
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep = torch.cat(
        [
            torch.ones_like(cum[..., :1], dtype=torch.bool),
            cum[..., :-1] < top_p[..., None],
        ],
        dim=-1,
    )
    thresh = torch.where(
        keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, neg), logits)


def sample_slot_tokens(
    logits, seeds, steps, temps, top_ps, *,
    sampling: bool = True, nucleus: bool = True,
):
    """Per-slot sampling over [S, V] logits → [S] int64 tokens.

    Greedy argmax where ``temps <= 0``; otherwise Gumbel-max over
    ``logits / T`` (nucleus-filtered where ``top_p < 1``) with the noise
    of :func:`gumbel_noise` at (seed, step). ``sampling``/``nucleus``
    are host-known facts about the batch (the engine knows each lane's
    request): ``sampling=False`` skips the noise, ``nucleus=False`` the
    vocab sort — the results are unchanged whenever the flags are true
    to the batch.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    drawing = temps > 0
    safe_t = torch.where(drawing, temps, torch.ones_like(temps))
    scaled = logits / safe_t[:, None]
    if nucleus:
        scaled = torch.where(
            (top_ps < 1.0)[:, None], nucleus_filter(scaled, top_ps), scaled
        )
    drawn = torch.argmax(
        scaled + gumbel_noise(seeds, steps, logits.shape[-1]), dim=-1
    )
    return torch.where(drawing, drawn, greedy)


@torch.no_grad()
def slot_decode_sample_step(
    model: CausalLM, cache: SlotCache, tokens, seeds, steps, temps, top_ps,
    *, attn_impl: str = "reference", sampling: bool = True,
    nucleus: bool = True,
):
    """:func:`slot_decode_step` with sampling fused → the next [S]
    tokens; ``steps`` (each lane's emitted-token index) advances by one
    in place. All of it stays on the device."""
    logits = slot_decode_step(model, cache, tokens, attn_impl=attn_impl)
    toks = sample_slot_tokens(
        logits, seeds, steps, temps, top_ps,
        sampling=sampling, nucleus=nucleus,
    )
    steps.add_(1)
    return toks


def sample_slot_tokens_block(
    logits, seeds, steps, temps, top_ps, *,
    sampling: bool = True, nucleus: bool = True,
):
    """Per-(slot, offset) sampling over [S, K, V] logits → [S, K] int64.

    The verify step's sibling of :func:`sample_slot_tokens`: offset j of
    lane s draws with the noise of step ``steps[s] + j``, so row (s, j)
    is the very token :func:`sample_slot_tokens` draws for lane s at
    that step — what keeps seeded acceptance exact. The [S·K] rows go
    through :func:`sample_slot_tokens` at once, under the same host
    flags.
    """
    S, K, V = logits.shape
    offs = torch.arange(K, device=steps.device)
    toks = sample_slot_tokens(
        logits.reshape(S * K, V),
        seeds.repeat_interleave(K),
        (steps[:, None] + offs[None, :]).reshape(-1),
        temps.repeat_interleave(K),
        top_ps.repeat_interleave(K),
        sampling=sampling, nucleus=nucleus,
    )
    return toks.reshape(S, K)


@torch.no_grad()
def slot_verify_step(
    model: CausalLM, cache, tokens, drafts, seeds, steps, temps, top_ps,
    *, sampling: bool = True, nucleus: bool = True,
):
    """Speculative decoding's verify: score K draft tokens per lane in
    ONE target step → ``(next_toks [S], target [S, K], matched [S])``.

    ``tokens`` [S]: each lane's last accepted token; ``drafts`` [S, K]:
    the draft's proposals d_1..d_K. The inputs ``[token, d_1..d_{K-1}]``
    run at positions ``pos[s] + j`` (the position embedding clamped at
    L-1), K/V written (quantized on an int8 cache) before the attention,
    which is plain fp32 over :func:`_full_kv` under the banded mask
    ``key <= pos[s] + j``. The write start clamps at ``L - K`` (on a
    paged cache the clamped positions map through the tables, writes of
    an unmapped lane landing in the scratch page): the engine reserves
    K-1 positions at admission, so only an idle lane parked at the
    position ceiling meets the clamp. ``target[s, j]`` is sampled at
    step ``steps[s] + j`` (:func:`sample_slot_tokens_block`), i.e. the
    token the non-speculative loop emits there.

    ``matched`` counts the leading positions where draft == target. The
    lane emits n = min(matched + 1, K) tokens, ``target[s, :n]``;
    ``next_toks`` is ``target[s, n - 1]``, and ``cache.pos`` (clamped at
    L) and ``steps`` advance by n in place, so rejected rows sit above
    ``pos`` until the next round overwrites them. No host sync.
    ``ddp_tpu/models/generate.py`` ``slot_verify_step``, line for line.
    """
    spec = model.spec
    L = spec.total_len
    S, K = drafts.shape
    G = spec.num_heads // spec.kv_heads
    dev = drafts.device
    pos = cache.pos.long()
    inputs = torch.cat([tokens[:, None].long(), drafts[:, :-1].long()], dim=1)
    offs = torch.arange(K, device=dev)
    q_end = pos[:, None] + offs[None, :]  # [S, K] absolute positions
    x = model.embed[inputs] + model.pos_embed[0][
        torch.clamp(q_end, max=L - 1)]
    wstart = torch.clamp(pos, max=L - K)
    paged = isinstance(cache, PagedSlotCache)
    if paged:
        pids, woffs = _page_scatter_ids(
            cache.table, wstart[:, None] + offs[None, :], cache.page_size)
    live = (torch.arange(L, device=dev)[None, None, :]
            <= q_end[:, :, None])[:, None]  # [S, 1, K, L]
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv(x)  # [S, K, H, Dh], [S, K, H_kv, Dh]
        if paged:
            _write_pages(cache, i, pids, woffs, k, v)
        else:
            _write_kv_rows(cache, i, k, v, wstart)
        kf, vf = _full_kv(cache, i)  # [S, L, H_kv, Dh] fp32
        logits = torch.einsum(
            "sqhd,slhd->shql", q.float(), kf.repeat_interleave(G, dim=2)
        ) * spec.head_dim**-0.5
        w = torch.softmax(logits.masked_fill(~live, -math.inf), dim=-1)
        attn = torch.einsum("shql,slhd->sqhd", w,
                            vf.repeat_interleave(G, dim=2))
        x = blk.finish(x, attn.reshape(S, K, spec.d_model).to(x.dtype))
    target = sample_slot_tokens_block(
        model.head(x), seeds, steps, temps, top_ps,
        sampling=sampling, nucleus=nucleus,
    )
    # Leading exact matches: cumprod makes the first mismatch a
    # permanent zero, so the sum is the accepted prefix's length.
    matched = torch.cumprod((target == drafts.long()).long(), dim=1).sum(dim=1)
    n = torch.clamp(matched + 1, max=K)
    next_toks = torch.gather(target, 1, (n - 1)[:, None])[:, 0]
    cache.pos.copy_(torch.clamp(pos + n, max=L))
    steps.add_(n)
    return next_toks, target, matched


@torch.no_grad()
def prefill_chunk_device(
    model: CausalLM,
    cache: SlotCache,
    toks,
    seeds,
    steps,
    temps,
    top_ps,
    slot,
    chunk,
    start,
    length,
    final,
    seed,
    temperature,
    top_p,
    *,
    lane_attend: bool = True,
):
    """:func:`prefill_chunk` over DEVICE scalars, with no host branch on
    a value and no host→device copy: the traced ``prefill_chunk`` of
    ``ddp_tpu/models/generate.py``, and what a CUDA graph of a chunk
    captures (``serve/programs.py``).

    ``slot``, ``start``, ``length``, ``final``, ``seed`` are 0-dim
    integer tensors and ``temperature``, ``top_p`` 0-dim float tensors,
    on ``chunk``'s device; only ``chunk``'s width C and ``lane_attend``
    shape the work. The write start ``max(0, min(start, L - C))``, the
    position-embedding rows, the lane's view and its table row are
    device index operations, the banded mask takes ``start`` as a
    tensor, and the request's first token is always drawn (at step 0,
    with the fused sampler: greedy where ``temperature <= 0``) and lands
    in ``toks[slot]`` only where ``final``. The lane's ``pos`` becomes
    ``start + length`` and its sampling state the request's (``steps``
    1 if final, else 0). Returns the drawn token as a 0-dim tensor
    (meaningful only where final).
    """
    spec = model.spec
    L = spec.total_len
    C = chunk.shape[0]
    G = spec.num_heads // spec.kv_heads
    dev = chunk.device
    lane = slot.reshape(1).long()
    start = start.long()
    offs = torch.arange(C, device=dev)
    wpos = torch.clamp(torch.clamp(start, max=L - C), min=0) + offs
    x = (model.embed[chunk.long()][None]
         + model.pos_embed[0].index_select(0, wpos)[None])
    quant = cache.quantized()
    paged = isinstance(cache, PagedSlotCache)
    if paged:
        row = cache.table.index_select(0, lane)[0]  # [lane_pages] int32
        pids, poffs = _page_scatter_ids(row, start + offs, cache.page_size)
    else:
        at = (lane.expand(C), wpos)
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv(x)  # [1, C, H, Dh], [1, C, H_kv, Dh]
        if paged:
            _write_pages(cache, i, pids, poffs, k[0], v[0])
        elif quant:
            wk, ks = quantize_kv(k[0])
            wv, vs = quantize_kv(v[0])
            cache.k_scale[i].index_put_(at, ks)
            cache.v_scale[i].index_put_(at, vs)
            cache.k[i].index_put_(at, wk)
            cache.v[i].index_put_(at, wv)
        else:
            cache.k[i].index_put_(at, k[0].to(cache.k.dtype))
            cache.v[i].index_put_(at, v[0].to(cache.v.dtype))
        if lane_attend:
            lane_ks = lane_vs = None
            if paged:
                lane_k = gather_paged_kv(cache.k[i], row[None])[0]
                lane_v = gather_paged_kv(cache.v[i], row[None])[0]
                if quant:
                    lane_ks = gather_paged_kv(cache.k_scale[i], row[None])[0]
                    lane_vs = gather_paged_kv(cache.v_scale[i], row[None])[0]
            else:
                lane_k = cache.k[i].index_select(0, lane)[0]
                lane_v = cache.v[i].index_select(0, lane)[0]
                if quant:
                    lane_ks = cache.k_scale[i].index_select(0, lane)[0]
                    lane_vs = cache.v_scale[i].index_select(0, lane)[0]
            if quant:
                lane_k = dequantize_kv(lane_k, lane_ks)
                lane_v = dequantize_kv(lane_v, lane_vs)
            attn = dot_product_attention(
                q.float(),
                lane_k.repeat_interleave(G, dim=1)[None].float(),
                lane_v.repeat_interleave(G, dim=1)[None].float(),
                causal=True,
                q_offset=start,
            )
        else:
            attn = dot_product_attention(
                q.float(),
                k.repeat_interleave(G, dim=2).float(),
                v.repeat_interleave(G, dim=2).float(),
                causal=True,
            )
        x = blk.finish(x, attn.reshape(1, C, spec.d_model).to(x.dtype))
    last = (torch.clamp(length.long(), min=1, max=C) - 1).reshape(1)
    logits = model.head(x.index_select(1, last)[:, 0])  # [1, V]
    fin = final.reshape(1) != 0
    first = sample_slot_tokens(
        logits, seed.reshape(1).long(),
        torch.zeros(1, dtype=torch.int64, device=dev),
        temperature.reshape(1).float(), top_p.reshape(1).float(),
    )
    toks.index_put_((lane,), torch.where(
        fin, first.to(toks.dtype), toks.index_select(0, lane)))
    cache.pos.index_put_((lane,), (start + length).reshape(1).to(
        cache.pos.dtype))
    seeds.index_put_((lane,), seed.reshape(1).to(seeds.dtype))
    steps.index_put_((lane,), fin.to(steps.dtype))
    temps.index_put_((lane,), temperature.reshape(1).to(temps.dtype))
    top_ps.index_put_((lane,), top_p.reshape(1).to(top_ps.dtype))
    return first[0]


def prefill_chunk(
    model: CausalLM,
    cache: SlotCache,
    toks,
    seeds,
    steps,
    temps,
    top_ps,
    slot: int,
    chunk,
    start: int,
    length: int,
    final: bool,
    seed: int,
    temperature: float,
    top_p: float,
    *,
    lane_attend: bool = True,
):
    """Ingest ONE chunk of a prompt into lane ``slot``, in place.

    ``chunk`` [C] holds prompt tokens for positions [start, start +
    length), padding after. K/V for all C positions are written first
    (quantized on an int8 cache); ``lane_attend=True`` then attends the
    full dequantized lane under the banded mask ``key <= start + i``
    (continuation chunks), ``False`` attends the chunk against itself
    (the first chunk, ``start == 0``). The write start and the position
    embedding rows clamp at ``L - C`` as JAX's dynamic slices do.

    On a :class:`PagedSlotCache` the chunk's positions [start, start +
    C) map through lane ``slot``'s table row (computed once, outside the
    layer loop) and the lane's view is gathered through it, so a
    continuation chunk after a prefix hit attends the matched prefix
    pages, which it never prefilled. The engine keeps start + C <=
    total_len; a position past the table's end would write the scratch
    page.

    Sets ``pos[slot] = start + length`` and installs the request's
    sampling state at ``slot`` (``steps`` 1 on the final chunk, else
    0). On the final chunk the request's first token is sampled at step
    0 and spliced into ``toks[slot]``; returns it as a device scalar,
    else None.

    A host-argument wrapper of :func:`prefill_chunk_device`: the scalars
    go to the device, and the work is that function's.
    """
    dev = toks.device

    def i64(v):
        return torch.tensor(int(v), dtype=torch.int64, device=dev)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    first = prefill_chunk_device(
        model, cache, toks, seeds, steps, temps, top_ps, i64(slot), chunk,
        i64(start), i64(length), i64(bool(final)), i64(seed),
        f32(temperature), f32(top_p), lane_attend=lane_attend,
    )
    return first if final else None
