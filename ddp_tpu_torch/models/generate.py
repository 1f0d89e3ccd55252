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
  (Sarathi-style chunked prefill), plain-torch attention.
- Seeded sampling by Gumbel-max from a counter-based generator keyed by
  (seed, emitted-token index, vocab id), in torch integer ops on the
  device, with no ``torch.Generator`` per lane. A seeded stream thus
  depends only on its own seed and step, as the JAX engine's
  ``fold_in(key(seed), step)`` stream does — but the bits differ from
  JAX's threefry, so seeded streams are held to the sampling invariants
  and greedy streams to token identity.

Idle lanes are decoded too (the batch shape never changes); position 0
is always live, so their outputs are finite garbage the engine ignores.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ddp_tpu_torch.models.lm import CausalLM, LMSpec
from ddp_tpu_torch.ops.attention import dot_product_attention
from ddp_tpu_torch.ops.decode import (
    decode_attention,
    dequantize_kv,
    quantize_kv,
)


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


@torch.no_grad()
def slot_decode_step(
    model: CausalLM, cache: SlotCache, tokens, *, attn_impl: str = "reference"
):
    """Feed ``tokens`` [S] (slot s's token at ``cache.pos[s]``) →
    logits [S, vocab] fp32; the cache and ``pos`` advance in place.

    ``pos`` clamps at ``total_len`` so an idle slot can sit in the batch
    indefinitely; the position embedding reads ``pos_embed[min(pos,
    L-1)]``. ``attn_impl`` picks the decode attention (``reference`` the
    plain version, ``flash``/``auto`` the CUDA kernel on the GPU).
    """
    spec = model.spec
    L = spec.total_len
    S = tokens.shape[0]
    pos = cache.pos
    x = model.embed[tokens.long()][:, None, :]  # [S, 1, d]
    pe = model.pos_embed[0]
    x = x + pe[torch.clamp(pos, max=L - 1).long()][:, None, :]
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv(x)
        _write_kv_rows(cache, i, k, v, pos)
        ksc, vsc = cache.lane_scales(i)
        attn = decode_attention(
            q[:, 0], cache.k[i], cache.v[i], pos, ksc, vsc, impl=attn_impl
        )  # [S, H, Dh] fp32
        x = blk.finish(x, attn.reshape(S, 1, spec.d_model).to(x.dtype))
    logits = model.head(x[:, 0])
    pos.add_(1).clamp_(max=L)
    return logits


# ---- sampling ---------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors holding uint32 values, with no
    int64 overflow (the product is formed from 16-bit halves)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (Wellons' lowbias32), a bijection on
    uint32 values held in int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


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


@torch.no_grad()
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
    embedding slice clamp at ``L - C`` as JAX's dynamic slices do.

    Sets ``pos[slot] = start + length`` and installs the request's
    sampling state at ``slot`` (``steps`` 1 on the final chunk, else
    0). On the final chunk the request's first token is sampled at step
    0 and spliced into ``toks[slot]``; returns it as a device scalar,
    else None.
    """
    spec = model.spec
    L = spec.total_len
    C = chunk.shape[0]
    G = spec.num_heads // spec.kv_heads
    w0 = max(0, min(start, L - C))
    x = model.embed[chunk.long()][None] + model.pos_embed[:, w0 : w0 + C]
    quant = cache.quantized()
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv(x)  # [1, C, H, Dh], [1, C, H_kv, Dh]
        if quant:
            wk, ks = quantize_kv(k[0])
            wv, vs = quantize_kv(v[0])
            cache.k_scale[i, slot, w0 : w0 + C] = ks
            cache.v_scale[i, slot, w0 : w0 + C] = vs
        else:
            wk, wv = k[0], v[0]
        cache.k[i, slot, w0 : w0 + C] = wk.to(cache.k.dtype)
        cache.v[i, slot, w0 : w0 + C] = wv.to(cache.v.dtype)
        if lane_attend:
            lane_k, lane_v = cache.k[i, slot], cache.v[i, slot]
            if quant:
                lane_k = dequantize_kv(lane_k, cache.k_scale[i, slot])
                lane_v = dequantize_kv(lane_v, cache.v_scale[i, slot])
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
    first = None
    if final:
        last = min(max(length, 1), C) - 1
        logits = model.head(x[:, last])  # [1, V]
        dev = toks.device
        first = sample_slot_tokens(
            logits,
            torch.tensor([seed], dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.tensor([temperature], dtype=torch.float32, device=dev),
            torch.tensor([top_p], dtype=torch.float32, device=dev),
            sampling=temperature > 0,
            nucleus=temperature > 0 and top_p < 1.0,
        )[0]
        toks[slot] = first
    cache.pos[slot] = start + length
    seeds[slot] = seed
    steps[slot] = 1 if final else 0
    temps[slot] = temperature
    top_ps[slot] = top_p
    return first
