"""Flash attention with a forward and a backward kernel, on [B, T, H, D].

The PyTorch counterpart of ``ddp_tpu/ops/flash.py``. Every layer of the
causal-LM training step runs it once forward and once backward:

- :func:`attention_with_lse_reference` — the plain version: dense fp32
  einsum-softmax giving ``(out, lse)``, the end-anchored causal mask
  (key ≤ t + S − T), and out 0 / lse −inf on a row with no live key
  (what the kernel gives; JAX's ``_reference`` gives NaN there).
- :func:`flash_attention_with_lse` and :func:`flash_attention` (its
  ``out``) — one ``torch.autograd.Function`` over the hand-written CUDA
  kernels of ``ops/csrc/flash_attn.cu`` (B1 forward, B2 dQ, B3 dK/dV;
  bf16 and fp32; the source note there says what bounds them and how;
  :func:`kernel_config` says which design runs for a dtype and head dim;
  :func:`kernels_take` says which shapes the kernels take). The
  forward saves ``(q, k, v, out, lse)`` as ``_fa_fwd`` does; the
  backward folds the lse cotangent in as
  ``delta' = rowsum(dO∘O) − dLSE`` (fp32) and runs B2 then B3. On a
  CUDA tensor they launch the kernels or raise; on a CPU tensor they
  take the plain version, because there is no kernel to run there.
- :func:`make_flash_attention` — the ``(q, k, v) -> out`` contract.
- :func:`tf32_round` and :func:`tf32x3_matmul` — a plain emulation of the
  fp32 kernels' three-pass TF32 products, for the tests (nothing on the
  main path calls them).

Launches are counted per kernel and dtype in ``flash_attention.launches``
(one increment where a kernel is launched, nowhere else).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ddp_tpu_torch.ops import _build

# The kernels' limits (ops/csrc/flash_attn.cu): head_dim a multiple of
# 16 up to 128 (tensor-core k-steps of 16; tiles are sized for 128).
MAX_HEAD_DIM = 128
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}
KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")
# Rows of the tiles the sm90 kernels load by TMA (flash_attn.cu kFwdBQ,
# kFwdBK, kDqBQ, kDqBK, kDkvBQ, kDkvBK): B1 128 query rows and 128-key
# tiles; B2 128 query rows (Q and dO) and 64-key tiles; B3 128 keys and
# 64-row Q/dO tiles. A TMA box is 64 columns (128 bytes of bf16, the
# swizzle span) by that many rows.
SM90_ROWS = {"flash_attn_fwd": {"q": 128, "kv": 128},
             "flash_attn_dq": {"q": 128, "kv": 64},
             "flash_attn_dkv": {"q": 64, "kv": 128}}
TMA_BOX_COLS = 64
# The sm90 kernels that draw work items from a counter (persistent).
PERSISTENT = ("flash_attn_fwd", "flash_attn_dq")
# Rows of the tiles of the fp32 kernels (flash_attn.cu kTfFwdBQ, kTfFwdBK,
# kTfDqBQ, kTfDqBK, kTfDkvBQ, kTfDkvBK): B1 128 query rows and 64-key
# tiles; B2 128 query rows and 32-key tiles; B3 128 keys and 32-row Q/dO
# tiles.
TF32_ROWS = {"flash_attn_fwd": {"q": 128, "kv": 64},
             "flash_attn_dq": {"q": 128, "kv": 32},
             "flash_attn_dkv": {"q": 32, "kv": 128}}


def kernels_take(dtype: torch.dtype, head_dim: int) -> bool:
    """True when B1–B3 take q/k/v of ``dtype`` at ``head_dim``: bf16 or
    fp32, head_dim a multiple of 16 in [16, 128]."""
    return (dtype in _IS_BF16 and head_dim % 16 == 0
            and 16 <= head_dim <= MAX_HEAD_DIM)


def route(device_type: str, dtype: torch.dtype, head_dim: int) -> str:
    """Where one block of attention runs: "kernel" (B1–B3), "routed" (the
    plain block on the device, because the kernels do not take the shape
    — the JAX dispatch's choice by shape) or "plain" (a CPU tensor)."""
    if device_type == "cpu":
        return "plain"
    return "kernel" if kernels_take(dtype, head_dim) else "routed"


def takes_block(q: torch.Tensor) -> bool:
    """:func:`route` for ``q``: True → the kernels. A call routed to the
    plain block on a device is counted in ``flash_attention.plain_routed``."""
    way = route(q.device.type, q.dtype, q.shape[-1])
    if way == "routed":
        flash_attention.plain_routed += 1
    return way == "kernel"


def kernel_config(name: str, dtype: torch.dtype, head_dim: int) -> dict:
    """Which kernel ``name`` runs for ``dtype`` and ``head_dim``.

    ``design`` is "sm90" in bf16 (TMA, mbarriers and wgmma with register
    accumulators) and "tf32x3" in fp32 (three-pass TF32 mma.sync products
    with register accumulators and a cp.async ring), for each of B1–B3.
    Both run a head-dim tile of 64 columns for D ≤ 64 and 128 above, the
    padding filled with zeros. Raises outside the kernels' range, as the
    wrappers do.
    """
    _check(name in KERNELS, f"unknown kernel {name}")
    _check(dtype in _IS_BF16, f"unsupported dtype {dtype}")
    _check(
        kernels_take(dtype, head_dim),
        f"head_dim {head_dim} must be a multiple of 16 in [16, {MAX_HEAD_DIM}]",
    )
    bf16 = dtype == torch.bfloat16
    rows = SM90_ROWS if bf16 else TF32_ROWS
    return {"design": "sm90" if bf16 else "tf32x3",
            "head_tile": 64 if head_dim <= 64 else 128,
            **{f"{k}_rows": v for k, v in rows[name].items()}}


def tma_geometry(x: torch.Tensor, rows: int) -> tuple:
    """The 4-D tiled tensor map of a [B, L, H, D] view as the sm90
    kernels read it: dims (D, H, L, B) innermost first, the byte strides
    of H, L and B, and the box (64 columns, 1 head, ``rows`` rows, 1
    batch) → 11 ints. Rows past L and columns past D arrive as zeros."""
    B, L, H, D = x.shape
    size = x.element_size()
    sb, st, sh = (s * size for s in x.stride()[:3])
    return (D, H, L, B, sh, st, sb, TMA_BOX_COLS, 1, rows, 1)


def _tma_array(name, tensors):
    """The geometry of q, k, v (and dO for B2 and B3) for an sm90 launch."""
    rows = SM90_ROWS[name]
    vals = []
    for x, side in zip(tensors, ("q", "kv", "kv", "q")):
        vals += tma_geometry(x, rows[side])
    return (ctypes.c_int64 * len(vals))(*vals)


def _sm90_extras(name, tensors):
    """(tensor-map geometry, work counter) of a launch of ``name`` on
    ``tensors`` (q, k, v and dO where the kernel reads it): the counter,
    one int32 at 0, only for the persistent kernels; (None, None) in fp32,
    whose kernels take neither."""
    q = tensors[0]
    if kernel_config(name, q.dtype, q.shape[-1])["design"] != "sm90":
        return None, None
    ticket = (torch.zeros(1, dtype=torch.int32, device=q.device)
              if name in PERSISTENT else None)
    return _tma_array(name, tensors), ticket


def _ptr(x):
    return None if x is None else x.data_ptr()


# ---- the plain version ----------------------------------------------


def attention_with_lse_reference(q, k, v, causal: bool = False):
    """Dense attention → (out [B,T,H,D] in q's dtype, lse [B,T,H] fp32).

    fp32 throughout; the causal mask is end-anchored (query t sees keys
    up to t + S − T). A row with no live key (T > S, causal) gives out 0
    and lse −inf, not NaN, and gradients of 0 there.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        T, S = logits.shape[-2:]
        mask = (
            torch.arange(T, device=q.device)[:, None] + (S - T)
            >= torch.arange(S, device=q.device)[None, :]
        )
        logits = logits.masked_fill(~mask, -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    # The shift only keeps exp in range; the result does not depend on it.
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m)).detach()
    e = torch.exp(logits - shift)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", e / l.clamp_min(1e-30), v.float())
    lse = torch.where(
        l > 0, shift + torch.log(l.clamp_min(1e-30)),
        torch.full_like(l, -math.inf),
    )
    return out.to(q.dtype), lse[..., 0].transpose(1, 2)


def _probs_and_ds(q, k, v, dout, lse, delta, causal):
    """The backward kernels' recomputation, dense in fp32: P = exp(S −
    lse) (0 where masked; a non-finite lse counts as 0.5·FLT_MAX, so an
    empty row has P = 0) and dS = P∘(dO·Vᵀ − delta') → [B,H,T,S] each."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        T, S = s.shape[-2:]
        mask = (
            torch.arange(T, device=q.device)[:, None] + (S - T)
            >= torch.arange(S, device=q.device)[None, :]
        )
        s = s.masked_fill(~mask, -math.inf)
    big = torch.full_like(lse, 0.5 * torch.finfo(torch.float32).max)
    lse = torch.where(torch.isfinite(lse), lse, big)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), v.float())
    return p, p * (dp - delta.float().transpose(1, 2)[..., None])


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool = False):
    """Plain version of B2: dq = scale · dS·K, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool = False):
    """Plain version of B3: dk = scale · dSᵀ·Q and dv = Pᵀ·dO."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * q.shape[-1] ** -0.5
    dv = torch.einsum("bhts,bthd->bshd", p, dout.float())
    return dk.to(q.dtype), dv.to(q.dtype)


# ---- the fp32 kernels' products, emulated ------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: on the fp32 bits, add half a
    TF32 ulp to the magnitude and clear the 13 low bits. A finite value
    that rounds past the largest TF32 becomes ±inf; ±inf and NaN stay."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b in fp32 as the fp32 kernels multiply: each operand split into
    big = tf32(x) and small = tf32(x − big), and small·big + big·small +
    big·big summed in fp32 (each of those products is exact in fp32).
    ``passes=1`` keeps big·big alone: one TF32 pass, the control. The
    card's accumulation truncates where this one rounds to nearest; the
    kernels keep each accumulation chain one tile long for that."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    out = a_big @ b_big
    if passes == 3:
        a_small = tf32_round(a.float() - a_big)
        b_small = tf32_round(b.float() - b_big)
        out = a_small @ b_big + a_big @ b_small + out
    return out


# ---- the kernels -----------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn.cu")
    head = [_I, _P, _P, _P]
    shape = [_I, _I, _I, _I, _I, _I, ctypes.c_float, _P]  # ..., strides
    # Each takes the tensor-map geometry before the stream, B1 and B2 also
    # their work counter.
    lib.flash_attn_fwd.argtypes = head + [_P, _P] + shape + [_P, _P, _P]
    lib.flash_attn_dq.argtypes = head + [_P, _P, _P, _P] + shape + [_P, _P, _P]
    lib.flash_attn_dkv.argtypes = head + [_P, _P, _P, _P, _P] + shape + [_P, _P]
    for fn in (lib.flash_attn_fwd, lib.flash_attn_dq, lib.flash_attn_dkv):
        fn.restype = _I
    lib.flash_attn_smem_bytes.argtypes = [_I, _I, _I]
    lib.flash_attn_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _aligned(x: torch.Tensor) -> bool:
    """16-byte loads and TMA reach every row: last dim contiguous, the
    base and the (b, t, h) strides on 16-byte boundaries."""
    size = x.element_size()
    return (
        x.stride(-1) == 1
        and x.data_ptr() % 16 == 0
        and all(s * size % 16 == 0 for s in x.stride()[:3])
    )


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: in place through its strides, or a
    contiguous copy when a row is not 16-byte aligned (not on the
    model's path: its q/k/v views are aligned)."""
    return x if _aligned(x) else x.contiguous()


def _check_inputs(q, k, v) -> None:
    _check(q.dim() == 4 and k.dim() == 4, "q/k/v must be [B, T|S, H, D]")
    B, T, H, D = q.shape
    S = k.shape[1]
    _check(
        tuple(k.shape) == (B, S, H, D) and k.shape == v.shape,
        f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)}",
    )
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(
        k.device == q.device and v.device == q.device,
        "q, k and v must be on one device",
    )
    _check(
        q.dtype in _IS_BF16 and k.dtype == q.dtype and v.dtype == q.dtype,
        f"q/k/v must all be float32 or bfloat16, got "
        f"{q.dtype}/{k.dtype}/{v.dtype}",
    )
    _check(
        kernels_take(q.dtype, D),
        f"head_dim {D} must be a multiple of 16 in [16, {MAX_HEAD_DIM}]",
    )
    _check(T >= 1 and S >= 1 and B >= 1 and H >= 1, "empty q or k")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(name: str, dtype: torch.dtype, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    flash_attention.launches[f"{name}_{_DTYPE_NAME[dtype]}"] += 1


def flash_forward(q, k, v, causal: bool):
    """Kernel B1 → (out [B,T,H,D], lse [B,T,H] fp32). CUDA tensors only."""
    _check_inputs(q, k, v)
    q, k, v = _readable(q), _readable(k), _readable(v)
    B, T, H, D = q.shape
    S = k.shape[1]
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    tma, ticket = _sm90_extras("flash_attn_fwd", (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(
            "flash_attn_fwd", q.dtype, _lib().flash_attn_fwd,
            _IS_BF16[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, T, S, H, D, int(causal),
            D**-0.5, _strides(q, k, v, out), tma, _ptr(ticket), stream,
        )
    return out, lse


def _dq_dkv_args(q, k, v, dout, lse, delta):
    _check_inputs(q, k, v)
    _check(
        dout.shape == q.shape and dout.dtype == q.dtype
        and lse.shape == q.shape[:3] and delta.shape == q.shape[:3]
        and lse.dtype == delta.dtype == torch.float32,
        "dout must match q; lse and delta must be float32 [B, T, H]",
    )
    return (_readable(q), _readable(k), _readable(v), _readable(dout),
            lse.contiguous(), delta.contiguous())


def flash_dq(q, k, v, dout, lse, delta, causal: bool):
    """Kernel B2 → dq [B,T,H,D] (input dtype). ``delta`` is
    rowsum(dO∘O) − dLSE, fp32 [B,T,H]. CUDA tensors only."""
    q, k, v, dout, lse, delta = _dq_dkv_args(q, k, v, dout, lse, delta)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    tma, ticket = _sm90_extras("flash_attn_dq", (q, k, v, dout))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(
            "flash_attn_dq", q.dtype, _lib().flash_attn_dq,
            _IS_BF16[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, T, k.shape[1], H, D, int(causal), D**-0.5,
            _strides(q, k, v, dout, dq), tma, _ptr(ticket), stream,
        )
    return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool):
    """Kernel B3 → (dk, dv) [B,S,H,D] (input dtype). CUDA tensors only."""
    q, k, v, dout, lse, delta = _dq_dkv_args(q, k, v, dout, lse, delta)
    B, T, H, D = q.shape
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    tma, _ = _sm90_extras("flash_attn_dkv", (q, k, v, dout))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(
            "flash_attn_dkv", q.dtype, _lib().flash_attn_dkv,
            _IS_BF16[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, T, k.shape[1], H, D,
            int(causal), D**-0.5, _strides(q, k, v, dout, dk, dv), tma,
            stream,
        )
    return dk, dv


def backward_delta(out, dout, dlse=None):
    """delta' = rowsum(dO∘O) − dLSE in fp32 [B,T,H] (``flash.py:357-358``;
    ``dlse`` None means zeros)."""
    delta = (dout.float() * out.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_backward(q, k, v, out, lse, dout, dlse, causal: bool):
    """Kernels B2 then B3 → (dq, dk, dv) in the input dtype."""
    dout = dout.to(q.dtype)
    delta = backward_delta(out, dout, dlse)
    dq = flash_dq(q, k, v, dout, lse, delta, causal)
    return (dq, *flash_dkv(q, k, v, dout, lse, delta, causal))


class _FlashAttentionWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, dout, dlse, ctx.causal),
                None)


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Attention → ``(out, lse)``, differentiable in both outputs.

    ``lse`` is [B, T, H] fp32, the logsumexp of the scaled logits per
    query row: partial results over disjoint key sets combine exactly
    (``parallel/ring.combine_attention_partials``). A CPU tensor takes
    :func:`attention_with_lse_reference`.
    """
    if q.device.type == "cpu":
        return attention_with_lse_reference(q, k, v, causal)
    return _FlashAttentionWithLse.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False):
    """Attention on [B, T, H, D] through kernels B1–B3 (out only; the
    unused lse's cotangent reaches the backward as zeros)."""
    return flash_attention_with_lse(q, k, v, causal)[0]


flash_attention.launches = {
    f"{name}_{dt}": 0 for name in KERNELS for dt in ("bf16", "fp32")
}
flash_attention_with_lse.launches = flash_attention.launches
# Blocks that the dispatchers (parallel/ring.default_block_fn,
# ops/attention.best_attention) sent to the plain block on a device
# because B1–B3 do not take their shape (:func:`takes_block`).
flash_attention.plain_routed = 0


def make_flash_attention(*, causal: bool = False):
    """Bind options → the framework's ``(q, k, v) -> out`` attention fn."""

    def fn(q, k, v):
        return flash_attention(q, k, v, causal)

    return fn
