"""Flash-decode: single-query attention over SlotCache key lanes.

The PyTorch counterpart of ``ddp_tpu/ops/decode.py``. Every decode step
of the serving engine runs S single-token queries against S cache lanes
of up to ``total_len`` keys, once per layer:

- :func:`decode_attention_reference` — the plain version, the same
  einsum math, fp32 casts and ``-inf`` band mask as the JAX reference.
- :func:`flash_decode_attention` — the wrapper of the hand-written CUDA
  kernel ``ops/csrc/flash_decode.cu`` (kernels B4 fp32 and B5 int8; the
  source note there says what bounds them and how). On a CUDA tensor it
  launches the kernel or raises; on a CPU tensor it takes the plain
  version, because there is no kernel to run there.
- :func:`quantize_kv` / :func:`dequantize_kv` — int8 KV storage with
  per-(position, head) fp32 scales; the kernel widens int8 rows in
  registers, so device-memory reads stay int8.
- :func:`kernel_takes` — the one predicate for "the kernels take this
  shape" (head dims, K/V dtype, strides); :func:`split_plan` — the
  kernel's split of the cache into chunks (split-K), from L and the SM
  count.
- :func:`decode_attention_split_reference` — the kernel's split and
  merge emulated in plain torch, for the tests (nothing on the main
  path calls it).
- :func:`decode_attention` — the engine-facing switch (``impl`` =
  ``auto | flash | reference``; ``auto`` is the kernel on a CUDA tensor
  of a shape it takes and the plain version elsewhere).
- :func:`shard_decode_attention` — the kernels on a ``model`` mesh
  (``decode.py:433``): each rank runs B4/B5 on its KV-head group (whole
  GQA groups) and their query heads, read in place, and the heads are
  all-gathered; where ``H_kv`` does not divide, one whole
  :func:`decode_attention` call on every rank, as JAX does.
- The paged forms, over a page pool ([num_pages, page_size, H_kv, Dh])
  and an int32 page table [S, lane_pages] (``models/generate.
  PagedSlotCache``): :func:`gather_paged_kv` (the lanes' views, the
  plain version's first step), :func:`paged_decode_attention_reference`
  (gather, then :func:`decode_attention_reference`),
  :func:`flash_decode_paged_attention` (kernels B4p/B5p: the same CUDA
  kernel reading each K/V row through the lane's page table, with no
  gather) and :func:`paged_decode_attention` (the engine's switch, with
  the routing rules of :func:`decode_attention`).

Launches are counted per kernel in ``flash_decode_attention.launches``
and ``flash_decode_paged_attention.launches`` (one increment where a
kernel is launched, nowhere else), so a run can show that its main path
went through the kernels; calls that ``auto`` routes to the plain
version on a device by shape are counted in each wrapper's
``plain_routed``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ddp_tpu_torch.ops import _build

# int8 quantization range: symmetric; the amax floor keeps all-zero rows
# (unwritten cache lines) exact zeros after a round trip, never NaN.
_INT8_MAX = 127.0
_AMAX_FLOOR = 1e-8

# The kernel's limits and geometry (ops/csrc/flash_decode.cu): a K/V row
# is split over R = next_pow2(ceil(Dh / 16)) threads, 16 columns each,
# loaded 16 bytes at a time; Dh <= 256 keeps R within half a warp.
MAX_HEAD_DIM = 256
THREADS = 128  # a CTA
KEYS_PER_ROW_GROUP = {torch.float32: 2, torch.int8: 4}  # kKeys
MAX_GROUP_TILE = 4  # query heads a CTA serves (kMaxGroup)
# Split-K: enough chunks that a launch has about this many CTAs per SM
# (the serving shape, 64 lane-head pairs, then fills the card: fp32 runs
# best at ~4 waves of its 2 resident CTAs a SM, int8 with every CTA
# resident at once), but each chunk reads at least MIN_CHUNK_BYTES of K
# and V, so that a short cache does not pay the merge kernel for
# parallelism it cannot use (all measured on an H100, PERF.md).
SPLIT_CTAS_PER_SM = {torch.float32: 8, torch.int8: 2}
MIN_CHUNK_BYTES = 64 * 1024


# ---- int8 KV quantization -------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H_kv, Dh] float K/V → (int8 rows, per-head fp32 scales).

    ``scale = max(amax, 1e-8) / 127`` over the head dim, then round
    half to even (``torch.round``, as ``jnp.round``) and clip to ±127.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=_AMAX_FLOOR) / _INT8_MAX
    q = torch.clamp(
        torch.round(xf / scale[..., None]), -_INT8_MAX, _INT8_MAX
    ).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` → fp32 rows."""
    return q.float() * scale[..., None].float()


# ---- the plain version ----------------------------------------------


def decode_attention_reference(q, k, v, pos, k_scale=None, v_scale=None):
    """Single-query banded attention → [S, H, Dh] fp32.

    ``q``: [S, H, Dh] (one query per lane); ``k``/``v``: [S, L, H_kv,
    Dh] cache lanes (fp32, or int8 with ``k_scale``/``v_scale`` [S, L,
    H_kv]); ``pos``: [S] int — lane s attends keys at positions
    ``<= pos[s]``. Query head h reads kv head h // G.
    """
    S, H, Dh = q.shape
    L, H_kv = k.shape[1], k.shape[2]
    G = H // H_kv
    kf = dequantize_kv(k, k_scale) if k.dtype == torch.int8 else k.float()
    vf = dequantize_kv(v, v_scale) if v.dtype == torch.int8 else v.float()
    qg = q.reshape(S, H_kv, G, Dh).float()
    logits = torch.einsum("bkgd,blkd->bkgl", qg, kf) * Dh**-0.5
    live = (
        torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    )[:, None, None, :]
    logits = logits.masked_fill(~live, -math.inf)
    w = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bkgl,blkd->bkgd", w, vf)
    return attn.reshape(S, H, Dh)


# ---- the kernel's split, emulated ------------------------------------


def decode_split_partials(q, k, v, pos, k_scale=None, v_scale=None, *,
                          chunk: int):
    """The kernel's per-chunk partials → (o [S, H, n, Dh], lse [S, H, n])
    fp32, n = ceil(L / chunk): chunk c is attention over the lane's live
    keys in [c·chunk, (c+1)·chunk), normalised by max(l, 1e-30), with
    lse = shift + log l (−inf and o = 0 where the chunk has no live key).
    The plain version's math per chunk, with the isfinite shift guard."""
    S, H, Dh = q.shape
    L, H_kv = k.shape[1], k.shape[2]
    G = H // H_kv
    n = -(-L // chunk)
    kf = dequantize_kv(k, k_scale) if k.dtype == torch.int8 else k.float()
    vf = dequantize_kv(v, v_scale) if v.dtype == torch.int8 else v.float()
    qg = q.reshape(S, H_kv, G, Dh).float()
    logits = torch.einsum("bkgd,blkd->bkgl", qg, kf) * Dh**-0.5
    live = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~live[:, None, None, :], -math.inf)
    pad = n * chunk - L
    logits = torch.nn.functional.pad(logits, (0, pad), value=-math.inf)
    vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    logits = logits.reshape(S, H_kv, G, n, chunk)
    m = logits.amax(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - shift)
    l = p.sum(dim=-1)  # [S, H_kv, G, n]
    o = torch.einsum("bkgnc,bnckd->bkgnd", p,
                     vf.reshape(S, n, chunk, H_kv, Dh))
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, shift[..., 0] + torch.log(l),
                      torch.full_like(l, -math.inf))
    return o.reshape(S, H, n, Dh), lse.reshape(S, H, n)


def merge_split_partials(o, lse):
    """The kernel's merge of n chunk partials, in chunk order c = 0, 1, …:
    out = Σ_c w_c·o_c / max(Σ_c w_c, 1e-30), w_c = exp(lse_c − max lse)
    — ``parallel/ring.combine_attention_partials``'s lse identity over n
    chunks (a chunk with lse −inf weighs 0) → [S, H, Dh]."""
    mx = lse.amax(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - shift),
                    torch.zeros_like(lse))
    num = torch.zeros_like(o[..., 0, :])
    den = torch.zeros_like(lse[..., 0])
    for c in range(lse.shape[-1]):
        num = num + w[..., c, None] * o[..., c, :]
        den = den + w[..., c]
    return num / torch.clamp(den, min=1e-30)[..., None]


def decode_attention_split_reference(q, k, v, pos, k_scale=None,
                                     v_scale=None, *, chunk: int):
    """The kernel's algorithm in plain torch: the partials of
    :func:`decode_split_partials` merged by :func:`merge_split_partials`
    → [S, H, Dh] fp32. It pins the split on the CPU; nothing on the main
    path calls it."""
    return merge_split_partials(*decode_split_partials(
        q, k, v, pos, k_scale, v_scale, chunk=chunk))


# ---- which shapes the kernel takes, and how it splits them ------------


def kernel_takes(num_heads: int, kv_heads: int, head_dim: int, kv_dtype,
                 kv_strides=None) -> bool:
    """True when kernels B4 (fp32 K/V) and B5 (int8 K/V) take this shape:
    H a multiple of H_kv; head_dim <= 256 and a whole number of 16-byte
    vectors (a multiple of 4 in fp32, of 16 in int8); and, for a strided
    [S, L, H_kv, Dh] view (``kv_strides`` in elements; None is a
    contiguous cache), a contiguous last dim and every row on a 16-byte
    boundary. Elsewhere ``auto`` takes the plain version."""
    per_vector = {torch.float32: 4, torch.int8: 16}.get(kv_dtype)
    if (per_vector is None or kv_heads < 1 or num_heads % kv_heads
            or not 0 < head_dim <= MAX_HEAD_DIM or head_dim % per_vector):
        return False
    if kv_strides is None:
        return True
    *outer, last = kv_strides
    return last == 1 and all(st % per_vector == 0 for st in outer)


def _tensors_take(q, k, v) -> bool:
    """:func:`kernel_takes` for these tensors, with q fp32 and the K/V
    base pointers on 16-byte boundaries."""
    H, Dh = q.shape[-2], q.shape[-1]
    return (
        q.dtype == torch.float32 and q.stride(-1) == 1
        and k.dim() == 4 and k.stride() == v.stride() and v.dtype == k.dtype
        and kernel_takes(H, k.shape[2], Dh, k.dtype, k.stride())
        and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    )


def threads_a_row(head_dim: int) -> int:
    """R: the threads that share one K/V row (16 columns each)."""
    r = 1
    while 16 * r < head_dim:
        r *= 2
    return r


def tile_keys(kv_dtype, head_dim: int) -> int:
    """Keys of one kernel tile (``flash_decode_tile_keys`` in the CUDA
    source): kKeys keys for each of the THREADS / R row groups."""
    return KEYS_PER_ROW_GROUP[kv_dtype] * (THREADS // threads_a_row(head_dim))


def group_tile(group: int) -> int:
    """Query heads one CTA serves (GT): 1, 2 or 4."""
    return group if group <= 2 else MAX_GROUP_TILE


def split_plan(L: int, ctas_per_chunk: int, sm_count: int, kv_dtype,
               head_dim: int) -> tuple[int, int]:
    """(keys a chunk, chunks) for a cache of L keys of ``kv_dtype`` at
    ``head_dim``, where ``ctas_per_chunk`` CTAs (lanes × kv heads ×
    query-head blocks) run each chunk index. Chunks are whole tiles, as
    many as give about SPLIT_CTAS_PER_SM CTAs per SM, each of at least
    MIN_CHUNK_BYTES of K and V."""
    tile = tile_keys(kv_dtype, head_dim)
    key_bytes = 2 * head_dim * (1 if kv_dtype == torch.int8 else 4)
    n_tiles = -(-L // tile)
    want = -(-SPLIT_CTAS_PER_SM[kv_dtype] * sm_count // ctas_per_chunk)
    min_tiles = -(-MIN_CHUNK_BYTES // (tile * key_bytes))
    per_chunk = min(n_tiles, max(min_tiles, -(-n_tiles // want)))
    chunk = per_chunk * tile
    return chunk, -(-L // chunk)


# ---- the kernel ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode.cu")
    lib.flash_decode_fp32.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, ctypes.c_float, _P, _I, _P,
    ]
    lib.flash_decode_fp32.restype = _I
    lib.flash_decode_int8.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        ctypes.c_float, _P, _I, _P,
    ]
    lib.flash_decode_int8.restype = _I
    lib.flash_decode_paged_fp32.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, ctypes.c_float, _P, _I, _P,
    ]
    lib.flash_decode_paged_fp32.restype = _I
    lib.flash_decode_paged_int8.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        ctypes.c_float, _P, _I, _P,
    ]
    lib.flash_decode_paged_int8.restype = _I
    lib.flash_decode_tile_keys.argtypes = [_I, _I]
    lib.flash_decode_tile_keys.restype = _I
    return lib


def build() -> dict[str, float]:
    """Build (or find built) the kernel library → {source: seconds}."""
    seconds = _build.build(("flash_decode.cu",))
    _lib()
    return seconds


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode_attention: {msg}")


def _check_inputs(q, k, v, pos, k_scale, v_scale) -> None:
    """Raise on inputs no decode attention takes (shapes, dtypes of pos
    and scales, devices)."""
    S, H, Dh = q.shape
    _check(k.dim() == 4, f"k must be [S, L, H_kv, Dh], got {tuple(k.shape)}")
    L, H_kv = k.shape[1], k.shape[2]
    _check(
        tuple(k.shape) == (S, L, H_kv, Dh) and k.shape == v.shape,
        f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)}",
    )
    _check(H % H_kv == 0, f"H {H} is not a multiple of H_kv {H_kv}")
    _check(
        pos.dtype == torch.int32 and tuple(pos.shape) == (S,)
        and pos.is_contiguous(),
        f"pos must be a contiguous int32 [{S}], got {pos.dtype} "
        f"{tuple(pos.shape)}",
    )
    tensors = [q, k, v, pos]
    if k.dtype == torch.int8:
        _check(
            k_scale is not None and v_scale is not None,
            "int8 K/V need k_scale and v_scale",
        )
        _check(
            tuple(k_scale.shape) == (S, L, H_kv)
            and k_scale.shape == v_scale.shape
            and k_scale.dtype == v_scale.dtype == torch.float32
            and k_scale.stride() == v_scale.stride(),
            "scales must be float32 [S, L, H_kv] with equal strides",
        )
        tensors += [k_scale, v_scale]
    _check(
        all(t.device == q.device for t in tensors),
        "all inputs must be on one device",
    )


def flash_decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *,
                           plan_kv_heads: int | None = None):
    """Banded single-query attention through the CUDA kernel →
    [S, H, Dh] fp32 (the contract of :func:`decode_attention_reference`).

    ``k``/``v`` may be any strided [S, L, H_kv, Dh] view that
    :func:`kernel_takes` — the engine passes one layer's slice of the
    cache, read in place. ``pos`` is an int32 [S] device tensor, read by
    the kernel (no host sync). A CPU tensor takes the plain version; a
    CUDA tensor of a shape the kernel does not take raises.
    ``plan_kv_heads``: the KV heads the cache's split is planned for
    (default ``k``'s), so that a shard of the heads is split as the
    whole call splits it and each head's result is the same bits.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos, k_scale, v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check_inputs(q, k, v, pos, k_scale, v_scale)
    _check(
        _tensors_take(q, k, v),
        f"the kernel does not take q {q.dtype} / K,V {k.dtype} at "
        f"head_dim {q.shape[-1]} with K/V strides {k.stride()} "
        f"(kernel_takes: head_dim <= {MAX_HEAD_DIM} in whole 16-byte "
        "vectors, rows on 16-byte boundaries)",
    )
    S, H, Dh = q.shape
    L, H_kv = k.shape[1], k.shape[2]
    G = H // H_kv
    gt = group_tile(G)
    y = H_kv * -(-G // gt)
    plan_y = (plan_kv_heads or H_kv) * -(-G // gt)
    chunk, n_chunks = split_plan(L, S * plan_y, _sm_count(q.device.index),
                                 k.dtype, Dh)
    out = torch.empty((S, H, Dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        partial = None
        if n_chunks > 1:  # the chunks' (o, lse), for the merge kernel
            partial = torch.empty(S * y * n_chunks * gt * (Dh + 1),
                                  dtype=torch.float32, device=q.device)
        common = (S, H, H_kv, Dh, L, q.stride(0), q.stride(1),
                  k.stride(0), k.stride(1), k.stride(2))
        tail = (Dh**-0.5, None if partial is None else partial.data_ptr(),
                chunk, stream)
        if k.dtype == torch.int8:
            name = "flash_decode_int8"
            err = _lib().flash_decode_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *common, k_scale.stride(0),
                k_scale.stride(1), k_scale.stride(2), *tail,
            )
        else:
            name = "flash_decode_fp32"
            err = _lib().flash_decode_fp32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *common, *tail,
            )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    flash_decode_attention.launches[name] += 1
    return out


flash_decode_attention.launches = {
    "flash_decode_fp32": 0,
    "flash_decode_int8": 0,
}
# Calls that ``auto`` sent to the plain version on a device because the
# kernel does not take their shape (a CPU tensor is not counted).
flash_decode_attention.plain_routed = 0


# ---- paged K/V: the lanes' views through int32 page tables ------------


def gather_paged_kv(pages, table):
    """[num_pages, page_size, ...] pool + [S, n] int32 table →
    [S, n·page_size, ...] per-lane views (K/V rows and their int8
    per-head scale planes alike: anything page-major)."""
    g = pages[table.long()]  # [S, n, page_size, ...]
    S, n, ps = g.shape[:3]
    return g.reshape(S, n * ps, *g.shape[3:])


def paged_decode_attention_reference(q, k_pages, v_pages, table, pos,
                                     k_scale=None, v_scale=None):
    """The plain paged version: the lanes' views gathered through
    ``table``, then :func:`decode_attention_reference` → [S, H, Dh] fp32
    (``ddp_tpu/ops/decode.py`` ``paged_decode_attention``'s semantics:
    positions past ``pos[s]``, scratch-page entries included, are
    masked)."""
    ks = gather_paged_kv(k_scale, table) if k_scale is not None else None
    vs = gather_paged_kv(v_scale, table) if v_scale is not None else None
    return decode_attention_reference(
        q, gather_paged_kv(k_pages, table), gather_paged_kv(v_pages, table),
        pos, ks, vs)


def _paged_tensors_take(q, k_pages, v_pages, table) -> bool:
    """:func:`_tensors_take` for a page pool: the pool's [num_pages,
    page_size, H_kv, Dh] strides as the kernel takes a lane's, a power
    of two page size, and a contiguous int32 [S, lane_pages] table."""
    ps = k_pages.shape[1] if k_pages.dim() == 4 else 0
    return (
        _tensors_take(q, k_pages, v_pages)
        and ps > 0 and ps & (ps - 1) == 0
        and table.dtype == torch.int32 and table.dim() == 2
        and table.is_contiguous() and table.shape[0] == q.shape[0]
        and 0 < table.shape[1] * ps <= 2**30
    )


def _check_paged_inputs(q, k_pages, v_pages, table, pos, k_scale,
                        v_scale) -> None:
    """Raise on inputs no paged decode attention takes."""
    S, H, Dh = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           f"k/v pages must be one [num_pages, page_size, H_kv, Dh] "
           f"shape, got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    P, ps, H_kv = k_pages.shape[:3]
    _check(k_pages.shape[3] == Dh, f"head dim {k_pages.shape[3]} != {Dh}")
    _check(H % H_kv == 0, f"H {H} is not a multiple of H_kv {H_kv}")
    _check(table.dim() == 2 and table.shape[0] == S
           and table.dtype == torch.int32,
           f"table must be int32 [{S}, lane_pages], got {table.dtype} "
           f"{tuple(table.shape)}")
    _check(pos.dtype == torch.int32 and tuple(pos.shape) == (S,)
           and pos.is_contiguous(),
           f"pos must be a contiguous int32 [{S}], got {pos.dtype} "
           f"{tuple(pos.shape)}")
    tensors = [q, k_pages, v_pages, table, pos]
    if k_pages.dtype == torch.int8:
        _check(k_scale is not None and v_scale is not None,
               "int8 K/V need k_scale and v_scale")
        _check(tuple(k_scale.shape) == (P, ps, H_kv)
               and k_scale.shape == v_scale.shape
               and k_scale.dtype == v_scale.dtype == torch.float32
               and k_scale.stride() == v_scale.stride(),
               "scales must be float32 [num_pages, page_size, H_kv] with "
               "equal strides")
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           "all inputs must be on one device")


def flash_decode_paged_attention(q, k_pages, v_pages, table, pos,
                                 k_scale=None, v_scale=None):
    """Banded single-query attention over paged lanes through the CUDA
    kernel (B4p fp32, B5p int8) → [S, H, Dh] fp32, the contract of
    :func:`paged_decode_attention_reference`.

    The kernel reads key ``key`` of lane ``s`` at page ``table[s, key >>
    log2(page_size)]``, row ``key & (page_size - 1)``, in place: no lane
    view is gathered. Everything else is :func:`flash_decode_attention`'s
    kernel, with the same split plan for L = lane_pages · page_size, so
    per row it computes exactly what that kernel computes over
    ``gather_paged_kv(pool, table)``. Table entries must lie in [0,
    num_pages) (the engine's tables hold page ids of its pool and 0, the
    scratch page). A CPU tensor takes the plain version; a CUDA tensor
    of a shape the kernel does not take raises.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, table, pos, k_scale, v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check_paged_inputs(q, k_pages, v_pages, table, pos, k_scale, v_scale)
    _check(
        _paged_tensors_take(q, k_pages, v_pages, table),
        f"the paged kernel does not take q {q.dtype} / K,V "
        f"{k_pages.dtype} at head_dim {q.shape[-1]}, page size "
        f"{k_pages.shape[1]}, pool strides {k_pages.stride()}, table "
        f"{tuple(table.shape)} (contiguous: {table.is_contiguous()}) "
        f"(kernel_takes, a power-of-two page size, a contiguous int32 "
        "table)",
    )
    S, H, Dh = q.shape
    ps, H_kv = k_pages.shape[1], k_pages.shape[2]
    lane_pages = table.shape[1]
    L = lane_pages * ps
    G = H // H_kv
    gt = group_tile(G)
    y = H_kv * -(-G // gt)
    chunk, n_chunks = split_plan(L, S * y, _sm_count(q.device.index),
                                 k_pages.dtype, Dh)
    out = torch.empty((S, H, Dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        partial = None
        if n_chunks > 1:
            partial = torch.empty(S * y * n_chunks * gt * (Dh + 1),
                                  dtype=torch.float32, device=q.device)
        common = (S, H, H_kv, Dh, lane_pages, ps.bit_length() - 1,
                  q.stride(0), q.stride(1), k_pages.stride(0),
                  k_pages.stride(1), k_pages.stride(2))
        tail = (Dh**-0.5, None if partial is None else partial.data_ptr(),
                chunk, stream)
        if k_pages.dtype == torch.int8:
            name = "flash_decode_paged_int8"
            err = _lib().flash_decode_paged_int8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), *common,
                k_scale.stride(0), k_scale.stride(1), k_scale.stride(2),
                *tail,
            )
        else:
            name = "flash_decode_paged_fp32"
            err = _lib().flash_decode_paged_fp32(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                table.data_ptr(), pos.data_ptr(), out.data_ptr(), *common,
                *tail,
            )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    flash_decode_paged_attention.launches[name] += 1
    return out


flash_decode_paged_attention.launches = {
    "flash_decode_paged_fp32": 0,
    "flash_decode_paged_int8": 0,
}
# Calls that ``auto`` sent to the plain paged version on a device by
# shape (a CPU tensor is not counted).
flash_decode_paged_attention.plain_routed = 0


# ---- runtime selection ----------------------------------------------


def resolve_impl(impl: str, device: torch.device, shape=None) -> str:
    """``auto`` → ``flash`` on a CUDA device, ``reference`` elsewhere.

    ``shape`` = (num_heads, kv_heads, head_dim, kv_dtype) of a contiguous
    cache, when given: on a CUDA device ``auto`` resolves to
    ``reference`` where :func:`kernel_takes` is false, and ``flash``
    raises there.
    """
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(
            f"unknown decode attention impl {impl!r}: expected "
            "'auto', 'flash' or 'reference'"
        )
    if torch.device(device).type != "cuda":
        return "reference" if impl == "auto" else impl
    if shape is not None and impl != "reference" and not kernel_takes(*shape):
        _check(impl == "auto", f"the kernel does not take {shape} "
               f"(kernel_takes is false)")
        return "reference"
    return "flash" if impl == "auto" else impl


def decode_attention(
    q, k, v, pos, k_scale=None, v_scale=None, *, impl: str = "reference"
):
    """The engine-facing entry: ``impl`` picks the path. ``auto`` takes
    the kernel on a CUDA tensor of a shape it takes, and the plain
    version elsewhere (on a device, counted in
    ``flash_decode_attention.plain_routed``); ``flash`` takes the kernel
    or raises."""
    resolve_impl(impl, q.device)  # raises on an unknown impl
    if impl == "reference" or q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos, k_scale, v_scale)
    if impl == "auto" and not _tensors_take(q, k, v):
        flash_decode_attention.plain_routed += 1
        return decode_attention_reference(q, k, v, pos, k_scale, v_scale)
    return flash_decode_attention(q, k, v, pos, k_scale, v_scale)


# A deliberate fault for the controls of the tests and the card's check:
# "offset" takes each rank's heads one KV head further on (wrapping).
SHARD_FAULT: str | None = None


def shard_decode_attention(mesh_or_comm, *, impl: str = "auto"):
    """The kernels over the ``model`` axis (``decode.py:433-481``):
    ``mesh_or_comm`` is a ``runtime/mesh.Mesh`` (its ``model``
    communicator) or that communicator. → ``fn(q, k, v, pos,
    k_scale=None, v_scale=None)`` on the full [S, H, Dh] queries and
    [S, L, H_kv, Dh] caches of every rank: rank r runs
    :func:`decode_attention` on KV heads [r·H_kv/tp, (r+1)·H_kv/tp) (and
    their scales, and the query heads of those groups), views of the
    inputs read in place, split as the whole call would be
    (``plan_kv_heads``), and the outputs are all-gathered along the heads
    → [S, H, Dh] on every rank. Where ``tp`` is 1 or does not divide
    ``H_kv``, one whole call on every rank (counted in
    ``shard_decode_attention.whole``)."""
    comm = (mesh_or_comm.comm("model") if hasattr(mesh_or_comm, "comm")
            else mesh_or_comm)
    tp = comm.size

    def fn(q, k, v, pos, k_scale=None, v_scale=None):
        H_kv = k.shape[2]
        if tp <= 1 or H_kv % tp:
            shard_decode_attention.whole += 1
            return decode_attention(q, k, v, pos, k_scale, v_scale,
                                    impl=impl)
        hk, hq = H_kv // tp, q.shape[1] // tp
        r = comm.rank
        if SHARD_FAULT == "offset":
            q, k, v = (t.roll(-(t.shape[h] // H_kv), h)
                       for t, h in ((q, 1), (k, 2), (v, 2)))
            if k_scale is not None:
                k_scale, v_scale = (s.roll(-1, 2) for s in (k_scale, v_scale))
        qs = q[:, r * hq:(r + 1) * hq]
        ks, vs = k[:, :, r * hk:(r + 1) * hk], v[:, :, r * hk:(r + 1) * hk]
        scales = (None, None) if k_scale is None else (
            k_scale[:, :, r * hk:(r + 1) * hk],
            v_scale[:, :, r * hk:(r + 1) * hk])
        impl_r = resolve_impl(impl, q.device)
        if impl_r == "flash" and q.device.type == "cuda" and \
                (impl == "flash" or _tensors_take(qs, ks, vs)):
            out = flash_decode_attention(qs, ks, vs, pos, *scales,
                                         plan_kv_heads=H_kv)
        else:
            out = decode_attention(qs, ks, vs, pos, *scales, impl=impl)
        return comm.all_gather(out, 1)

    return fn


shard_decode_attention.whole = 0


def paged_decode_attention(
    q, k_pages, v_pages, table, pos, k_scale=None, v_scale=None, *,
    impl: str = "reference",
):
    """The engine-facing paged entry, with :func:`decode_attention`'s
    rules: ``auto`` takes the paged kernel on a CUDA tensor of a shape it
    takes, and the plain paged version elsewhere (on a device, counted
    in ``flash_decode_paged_attention.plain_routed``); ``flash`` takes
    the kernel or raises; a CPU tensor always takes the plain version.
    Neither path gathers the lanes for the kernel."""
    resolve_impl(impl, q.device)  # raises on an unknown impl
    if impl == "reference" or q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, table, pos, k_scale, v_scale)
    if impl == "auto" and not _paged_tensors_take(q, k_pages, v_pages,
                                                  table):
        flash_decode_paged_attention.plain_routed += 1
        return paged_decode_attention_reference(
            q, k_pages, v_pages, table, pos, k_scale, v_scale)
    return flash_decode_paged_attention(
        q, k_pages, v_pages, table, pos, k_scale, v_scale)
