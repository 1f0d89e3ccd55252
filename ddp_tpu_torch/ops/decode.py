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
- :func:`decode_attention` — the engine-facing switch (``impl`` =
  ``auto | flash | reference``; ``auto`` is the kernel on a CUDA
  device and the plain version on the CPU).

Launches are counted per kernel in ``flash_decode_attention.launches``
(one increment where a kernel is launched, nowhere else), so a run can
show that its main path went through the kernels.
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

# The kernel's limits (ops/csrc/flash_decode.cu): head_dim up to 256,
# one block's shared memory under the 48 KB that needs no opt-in.
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 48 * 1024


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


# ---- the kernel ------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode.cu")
    lib.flash_decode_fp32.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, ctypes.c_float, _P,
    ]
    lib.flash_decode_fp32.restype = _I
    lib.flash_decode_int8.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        ctypes.c_float, _P,
    ]
    lib.flash_decode_int8.restype = _I
    lib.flash_decode_smem_bytes.argtypes = [_I, _I]
    lib.flash_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def build() -> dict[str, float]:
    """Build (or find built) the kernel library → {source: seconds}."""
    seconds = _build.build(("flash_decode.cu",))
    _lib()
    return seconds


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode_attention: {msg}")


def flash_decode_attention(q, k, v, pos, k_scale=None, v_scale=None):
    """Banded single-query attention through the CUDA kernel →
    [S, H, Dh] fp32 (the contract of :func:`decode_attention_reference`).

    ``k``/``v`` may be any strided [S, L, H_kv, Dh] view whose last dim
    is contiguous — the engine passes one layer's slice of the cache,
    read in place. ``pos`` is an int32 [S] device tensor, read by the
    kernel (no host sync). A CPU tensor takes the plain version.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos, k_scale, v_scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    S, H, Dh = q.shape
    _check(k.dim() == 4, f"k must be [S, L, H_kv, Dh], got {tuple(k.shape)}")
    L, H_kv = k.shape[1], k.shape[2]
    _check(
        tuple(k.shape) == (S, L, H_kv, Dh) and k.shape == v.shape,
        f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)}",
    )
    _check(H % H_kv == 0, f"H {H} is not a multiple of H_kv {H_kv}")
    _check(Dh <= MAX_HEAD_DIM, f"head_dim {Dh} > {MAX_HEAD_DIM}")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    quantized = k.dtype == torch.int8
    _check(
        k.dtype in (torch.float32, torch.int8) and v.dtype == k.dtype,
        f"k/v must both be float32 or int8, got {k.dtype}/{v.dtype}",
    )
    _check(
        q.stride(-1) == 1 and k.stride(-1) == 1 and k.stride() == v.stride(),
        "the last dim of q/k/v must be contiguous and k/v strides equal",
    )
    _check(
        pos.dtype == torch.int32 and tuple(pos.shape) == (S,)
        and pos.is_contiguous(),
        f"pos must be a contiguous int32 [{S}], got {pos.dtype} "
        f"{tuple(pos.shape)}",
    )
    tensors = [q, k, v, pos]
    if quantized:
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
    lib = _lib()
    G = H // H_kv
    _check(
        lib.flash_decode_smem_bytes(G, Dh) <= MAX_SMEM_BYTES,
        f"G {G} x head_dim {Dh} needs more than 48 KB of shared memory",
    )
    out = torch.empty((S, H, Dh), dtype=torch.float32, device=q.device)
    scale = Dh**-0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (S, H, H_kv, Dh, L, q.stride(0), q.stride(1),
                  k.stride(0), k.stride(1), k.stride(2))
        if quantized:
            name = "flash_decode_int8"
            err = lib.flash_decode_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *common, k_scale.stride(0),
                k_scale.stride(1), k_scale.stride(2), scale, stream,
            )
        else:
            name = "flash_decode_fp32"
            err = lib.flash_decode_fp32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), *common, scale, stream,
            )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    flash_decode_attention.launches[name] += 1
    return out


flash_decode_attention.launches = {
    "flash_decode_fp32": 0,
    "flash_decode_int8": 0,
}


# ---- runtime selection ----------------------------------------------


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` → ``flash`` on a CUDA device, ``reference`` elsewhere."""
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(
            f"unknown decode attention impl {impl!r}: expected "
            "'auto', 'flash' or 'reference'"
        )
    if impl == "auto":
        return "flash" if torch.device(device).type == "cuda" else "reference"
    return impl


def decode_attention(
    q, k, v, pos, k_scale=None, v_scale=None, *, impl: str = "reference"
):
    """The engine-facing entry: ``impl`` picks the path."""
    if resolve_impl(impl, q.device) == "flash":
        return flash_decode_attention(q, k, v, pos, k_scale, v_scale)
    return decode_attention_reference(q, k, v, pos, k_scale, v_scale)
