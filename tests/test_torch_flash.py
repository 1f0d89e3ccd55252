"""ddp_tpu_torch.ops.flash / parallel.ring: flash attention ≡ the JAX package.

The same numpy inputs, made from a seed, go through JAX's Pallas flash
kernels (``interpret=True``, as tests/test_flash.py runs them on the
CPU) and through the port (``device="cpu"``), forward and backward: out,
lse, and dq/dk/dv through ``jax.vjp`` against ``torch.autograd.grad``,
with a nonzero lse cotangent. On a CPU tensor the port's kernel wrappers
take the plain version (there is no kernel to launch here); the CUDA
kernels themselves are held against the plain version on the card by
chip_smoke.py.

Tolerances: fp32 atol 2e-5 (as tests/test_flash.py: the frameworks sum
in different orders). bf16: atol/rtol 2e-2 — both sides compute in fp32
from the same bf16 inputs and round the results to bf16, so they differ
by one or two bf16 ulps (2^-8 relative) at these magnitudes.
"""

import functools
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops import flash as jflash
from ddp_tpu.parallel import ring as jring
from ddp_tpu_torch.ops import _build
from ddp_tpu_torch.ops import attention as tattn
from ddp_tpu_torch.ops import flash as tflash
from ddp_tpu_torch.parallel import ring as tring

ATOL = 2e-5
BF16_TOL = 2e-2

CASES = [  # B, T, S, H, D, causal, block
    (2, 32, 32, 2, 16, True, 8),     # causal, four blocks a side
    (2, 32, 32, 2, 16, False, 16),   # non-causal
    (1, 8, 24, 2, 16, True, 8),      # causal T < S (end-anchored)
    (1, 24, 8, 2, 16, True, 8),      # causal T > S: rows t < 16 are empty
    (1, 13, 13, 3, 8, True, 512),    # ragged length, one whole block
]


def _inputs(seed, B, T, S, H, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return f(B, T, H, D), f(B, S, H, D), f(B, S, H, D), f(B, T, H, D), f(B, T, H)


def _jax_with_lse(q, k, v, do, dl, causal, block, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jflash.flash_attention_with_lse(
            q, k, v, causal, block, block, True
        ),
        *args,
    )
    grads = vjp((jnp.asarray(do, dtype), jnp.asarray(dl)))
    return [np.asarray(x, np.float32) for x in (out, lse, *grads)]


def _torch_with_lse(q, k, v, do, dl, causal, dtype=torch.float32):
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out, lse = tflash.flash_attention_with_lse(*leaves, causal)
    grads = torch.autograd.grad(
        (out, lse), leaves, (torch.tensor(do).to(dtype), torch.tensor(dl))
    )
    return [x.detach().float().numpy() for x in (out, lse, *grads)]


def _assert_close(got, want, atol, rtol=0.0):
    """Equal -inf rows count as equal (a row with no live key)."""
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,T,S,H,D,causal,block", CASES)
def test_with_lse_matches_jax_kernel(B, T, S, H, D, causal, block):
    """out, lse and dq/dk/dv (with a nonzero dLSE) ≡ the Pallas kernels."""
    x = _inputs(T * 100 + S, B, T, S, H, D)
    got = _torch_with_lse(*x, causal)
    want = _jax_with_lse(*x, causal, block)
    for g, w in zip(got, want):
        _assert_close(g, w, ATOL)
    if causal and T > S:  # empty rows: out 0, lse -inf, no NaN anywhere
        assert np.isneginf(got[1][:, : T - S]).all()
        assert (got[0][:, : T - S] == 0).all()
        assert all(np.isfinite(g).all() for g in got[2:])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(causal):
    """The out-only form: dLSE is zero, through the JAX custom VJP of
    ``flash_attention``."""
    q, k, v, do, _ = _inputs(5, 2, 32, 32, 2, 16)
    out, vjp = jax.vjp(
        lambda q, k, v: jflash.flash_attention(q, k, v, causal, 8, 8, True),
        *map(jnp.asarray, (q, k, v)),
    )
    want = [np.asarray(out), *map(np.asarray, vjp(jnp.asarray(do)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    t_out = tflash.flash_attention(*leaves, causal)
    got = [t_out, *torch.autograd.grad(t_out, leaves, torch.tensor(do))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL)
    fn = tflash.make_flash_attention(causal=causal)
    torch.testing.assert_close(fn(*leaves), t_out, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_jax_kernel(causal):
    """bf16 inputs: outputs and gradients come back in bf16 and agree with
    the Pallas kernels to a bf16 ulp or two."""
    x = _inputs(7, 1, 32, 32, 2, 16)
    got = _torch_with_lse(*x, causal, dtype=torch.bfloat16)
    want = _jax_with_lse(*x, causal, 8, dtype=jnp.bfloat16)
    for g, w in zip(got, want):
        _assert_close(g, w, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("T,S,causal", [(32, 32, True), (8, 24, True),
                                        (24, 8, True), (16, 16, False)])
def test_plain_dq_dkv_match_autograd(T, S, causal):
    """The plain versions of B2 and B3 (what chip_smoke.py holds the
    kernels against alone) ≡ autograd of the plain forward, dLSE
    folded into delta'."""
    q, k, v, do, dl = (torch.tensor(a) for a in _inputs(T + S, 2, T, S, 2, 16))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tflash.attention_with_lse_reference(*leaves, causal)
    want = torch.autograd.grad((out, lse), leaves, (do, dl))
    delta = tflash.backward_delta(out.detach(), do, dl)
    dq = tflash.flash_dq_reference(q, k, v, do, lse.detach(), delta, causal)
    dk, dv = tflash.flash_dkv_reference(q, k, v, do, lse.detach(), delta,
                                        causal)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_combine_partials_equals_whole_in_value_and_gradient():
    """Two key halves through the lse form, merged by
    combine_attention_partials, ≡ attention over all keys — values and
    gradients (the dLSE fold) — and ≡ the JAX combine."""
    q, k, v, do, _ = _inputs(11, 1, 32, 32, 2, 16)

    def split(q, k, v):
        o1, l1 = tflash.flash_attention_with_lse(q, k[:, :16], v[:, :16])
        o2, l2 = tflash.flash_attention_with_lse(q, k[:, 16:], v[:, 16:])
        return tring.combine_attention_partials(o1, l1, o2, l2)

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o, l = split(*leaves)
    whole, whole_l = tflash.attention_with_lse_reference(*leaves)
    torch.testing.assert_close(o, whole, atol=ATOL, rtol=0)
    torch.testing.assert_close(l, whole_l, atol=ATOL, rtol=0)
    g_split = torch.autograd.grad(o, leaves, torch.tensor(do))
    g_whole = torch.autograd.grad(whole, leaves, torch.tensor(do))
    for a, b in zip(g_split, g_whole):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    jo1, jl1 = jflash.flash_attention_with_lse(
        *(jnp.asarray(a[:, :16]) if i else jnp.asarray(a)
          for i, a in enumerate((q, k, v))), False, 16, 16, True)
    jo2, jl2 = jflash.flash_attention_with_lse(
        *(jnp.asarray(a[:, 16:]) if i else jnp.asarray(a)
          for i, a in enumerate((q, k, v))), False, 16, 16, True)
    jo, jl = jring.combine_attention_partials(jo1, jl1, jo2, jl2)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(l.detach().numpy(), np.asarray(jl), atol=ATOL)


def test_combine_with_an_empty_partial_is_identity():
    """l = -inf means "no keys seen": merging it changes nothing."""
    q, k, v, _, _ = (torch.tensor(a) for a in _inputs(12, 1, 8, 8, 2, 16))
    o, l = tflash.attention_with_lse_reference(q, k, v)
    o2, l2 = tring.combine_attention_partials(
        o, l, torch.zeros_like(o), torch.full_like(l, -torch.inf))
    torch.testing.assert_close(o2, o, atol=1e-6, rtol=0)
    torch.testing.assert_close(l2, l, atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_block_matches_jax(causal):
    """The one-rank ring: ``_xla_block_with_lse`` and ``ring_attention``
    (its hop-0 block, ``default_block_fn`` on the CPU) ≡ the JAX block,
    whose causal mask is anchored top-left — the flash kernel's mask at
    T == S, which is what a one-rank ring sees."""
    q, k, v, _, _ = _inputs(13, 2, 16, 16, 2, 16)
    jo, jl = jring._xla_block_with_lse(*map(jnp.asarray, (q, k, v)), causal)
    to, tl = tring._xla_block_with_lse(*map(torch.tensor, (q, k, v)), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    ring = tring.ring_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    np.testing.assert_allclose(ring.numpy(), np.asarray(jo), atol=ATOL)
    fo, fl = tflash.attention_with_lse_reference(
        *map(torch.tensor, (q, k, v)), causal)
    torch.testing.assert_close(fo, to, atol=ATOL, rtol=0)
    torch.testing.assert_close(fl, tl, atol=ATOL, rtol=0)


def test_best_attention_on_cpu_is_the_dense_path():
    q, k, v, _, _ = (torch.tensor(a) for a in _inputs(14, 1, 12, 12, 2, 16))
    for causal in (True, False):
        got = tattn.best_attention(causal=causal)(q, k, v)
        want = tattn.dot_product_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_non_cpu_tensor_raises_and_never_falls_back():
    """A tensor that is not on the CPU goes to the kernels: with no GPU
    here they raise (a meta tensor stands in for a CUDA one) and count no
    launch; the kernel entry points refuse CPU tensors; the library build
    names the missing nvcc."""
    before = dict(tflash.flash_attention.launches)
    meta = [torch.empty(1, 8, 2, 16, device="meta") for _ in range(3)]
    for fn in (tflash.flash_attention, tflash.flash_attention_with_lse):
        with pytest.raises(ValueError, match="unsupported device meta"):
            fn(*meta, True)
    cpu = [torch.zeros(1, 8, 2, 16) for _ in range(3)]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        tflash.flash_forward(*cpu, True)
    assert tflash.flash_attention.launches == before
    assert set(before) == {
        f"{k}_{d}" for k in tflash.KERNELS for d in ("bf16", "fp32")
    }
    assert (tflash.flash_attention_with_lse.launches
            is tflash.flash_attention.launches)


def test_kernel_source_is_built_with_the_rest(monkeypatch):
    """flash_attn.cu builds with flash_decode.cu (one nvcc each, started
    together) into the ignored build directory; no nvcc → a clear error."""
    assert "flash_attn.cu" in _build.SOURCES
    path = _build.library_path("flash_attn.cu")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("flash_attn-")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("flash_attn.cu",))


# ---- which kernel runs, and what the wrapper hands it (no card needed) ----


@pytest.mark.parametrize("D", range(16, 129, 16))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_config_per_dtype_and_head_dim(dtype, D):
    """B1, B2 and B3 run a 64-column head-dim tile up to D 64 and a
    128-column one above: in bf16 the sm90 kernels (TMA, wgmma, register
    accumulators; B2 128 query rows with 64-key tiles), in fp32 the
    three-pass TF32 kernels (mma.sync, register accumulators, a cp.async
    ring; B2 128 query rows with 32-key tiles)."""
    fwd, dq, dkv = (tflash.kernel_config(n, dtype, D) for n in tflash.KERNELS)
    tile = 64 if D <= 64 else 128
    if dtype == torch.bfloat16:
        assert fwd == {"design": "sm90", "head_tile": tile,
                       "q_rows": 128, "kv_rows": 128}
        assert dq == {"design": "sm90", "head_tile": tile,
                      "q_rows": 128, "kv_rows": 64}
        assert dkv == {"design": "sm90", "head_tile": tile,
                       "q_rows": 64, "kv_rows": 128}
    else:
        assert fwd == {"design": "tf32x3", "head_tile": tile,
                       "q_rows": 128, "kv_rows": 64}
        assert dq == {"design": "tf32x3", "head_tile": tile,
                      "q_rows": 128, "kv_rows": 32}
        assert dkv == {"design": "tf32x3", "head_tile": tile,
                       "q_rows": 32, "kv_rows": 128}


@pytest.mark.parametrize("D,taken", [(8, False), (16, True), (24, False),
                                     (128, True), (144, False)])
def test_kernels_take_and_the_routing_by_device_and_shape(D, taken):
    """B1-B3 take bf16/fp32 at D a multiple of 16 in [16, 128]. A device
    tensor of another shape takes the plain block on the device
    ("routed", the JAX dispatch's choice by shape), a CPU tensor the
    plain block ("plain"); float16 is never taken."""
    for dtype in (torch.bfloat16, torch.float32):
        assert tflash.kernels_take(dtype, D) is taken
        assert tflash.route("cuda", dtype, D) == ("kernel" if taken
                                                  else "routed")
        assert tflash.route("cpu", dtype, D) == "plain"
    assert not tflash.kernels_take(torch.float16, D)
    assert tflash.route("cuda", torch.float16, D) == "routed"


@pytest.mark.parametrize("D", [8, 24, 144])
def test_dispatchers_route_and_count_shapes_the_kernels_do_not_take(D):
    """On a device tensor (a meta tensor stands in for a CUDA one) whose
    head dim the kernels do not take, ``default_block_fn`` and
    ``best_attention`` take the plain block, count each call in
    ``flash_attention.plain_routed`` and launch nothing; the kernel entry
    itself still raises on that shape."""
    q, k, v = (torch.empty(1, 8, 2, D, device="meta") for _ in range(3))
    before = dict(tflash.flash_attention.launches)
    routed = tflash.flash_attention.plain_routed
    out, lse = tring.default_block_fn(q, k, v, True)
    assert out.shape == q.shape and lse.shape == (1, 8, 2)
    assert tattn.best_attention(causal=True)(q, k, v).shape == q.shape
    assert tflash.flash_attention.plain_routed == routed + 2
    assert tflash.flash_attention.launches == before
    cpu = [torch.zeros(1, 8, 2, D) for _ in range(3)]
    tring.default_block_fn(*cpu, True)  # the CPU is not counted
    assert tflash.flash_attention.plain_routed == routed + 2
    with pytest.raises(ValueError):  # an explicit kernel call never routes
        tflash.flash_attention(q, k, v, True)


@pytest.mark.parametrize("D", [0, 8, 24, 100, 144, 256])
def test_kernel_config_raises_outside_the_kernels_range(D):
    for name in tflash.KERNELS:
        with pytest.raises(ValueError, match=f"head_dim {D} must be"):
            tflash.kernel_config(name, torch.bfloat16, D)
    with pytest.raises(ValueError, match="unsupported dtype"):
        tflash.kernel_config("flash_attn_fwd", torch.float16, 64)


def test_tma_geometry_of_a_fused_qkv_view():
    """q/k/v as the model hands them over: views of one [B, T, H, 3, D]
    projection, read in place (token stride 3·H·D, head stride 3·D)."""
    B, T, H, D = 2, 256, 8, 128
    qkv = torch.zeros(B, T, H, 3, D, dtype=torch.bfloat16)
    q, k = qkv[:, :, :, 0], qkv[:, :, :, 1]
    assert tflash._aligned(q) and tflash._aligned(k)
    assert tflash.tma_geometry(q, 128) == (
        D, H, T, B, 3 * D * 2, 3 * H * D * 2, 3 * H * D * T * 2, 64, 1, 128, 1)
    # k starts D elements further on; the geometry is the same.
    assert tflash.tma_geometry(k, 64)[:7] == tflash.tma_geometry(q, 64)[:7]
    assert k.data_ptr() - q.data_ptr() == D * 2


@pytest.mark.parametrize("T,D", [(2048, 128), (1000, 128), (512, 96), (64, 16)])
def test_tma_geometry_of_contiguous_tensors(T, D):
    """A contiguous [B, T, H, D] tensor, a ragged T (TMA zero-fills rows
    past T) and a head dim that is not a tile width (the box stays 64
    columns; columns past D arrive as zeros)."""
    B, H = 3, 4
    x = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    geom = tflash.tma_geometry(x, 128)
    assert geom == (D, H, T, B, D * 2, H * D * 2, T * H * D * 2, 64, 1, 128, 1)
    assert all(s % 16 == 0 for s in geom[4:7])  # TMA's stride rule


def test_tma_array_per_kernel():
    """B1 loads 128-row tiles of q, k and v; B2 128-row q and dO and
    64-row k/v tiles; B3 128-row k/v and 64-row q and dO tiles: 11 values
    an operand, in the C entry points' order."""
    q = torch.zeros(1, 200, 2, 96, dtype=torch.bfloat16)
    kv = torch.zeros(1, 300, 2, 96, dtype=torch.bfloat16)
    fwd = list(tflash._tma_array("flash_attn_fwd", (q, kv, kv)))
    dq = list(tflash._tma_array("flash_attn_dq", (q, kv, kv, q)))
    dkv = list(tflash._tma_array("flash_attn_dkv", (q, kv, kv, q)))
    assert len(fwd) == 33 and len(dq) == 44 and len(dkv) == 44
    assert [fwd[i * 11 + 9] for i in range(3)] == [128, 128, 128]
    assert [dq[i * 11 + 9] for i in range(4)] == [128, 64, 64, 128]
    assert [dkv[i * 11 + 9] for i in range(4)] == [64, 128, 128, 64]
    assert fwd[:4] == [96, 2, 200, 1] and fwd[11:15] == [96, 2, 300, 1]
    assert dq[33:37] == [96, 2, 200, 1]  # dO, as q


def test_sm90_extras_per_kernel_and_dtype():
    """bf16 launches take the tensor maps, and the persistent B1 and B2 a
    work counter at 0; B3 takes no counter; fp32 launches take neither."""
    q = torch.zeros(1, 200, 2, 64, dtype=torch.bfloat16)
    for name, persistent in (("flash_attn_fwd", True), ("flash_attn_dq", True),
                             ("flash_attn_dkv", False)):
        tma, ticket = tflash._sm90_extras(name, (q, q, q, q))
        assert len(tma) == 44
        if persistent:
            assert ticket.dtype == torch.int32 and ticket.tolist() == [0]
        else:
            assert ticket is None
        assert tflash._sm90_extras(name, (q.float(),) * 4) == (None, None)


def test_build_flags_and_sources_carry_the_sm90_kernels(tmp_path, monkeypatch):
    """sm_90a (wgmma, setmaxnreg), ptxas's report kept, and the library
    keyed by every header beside the sources as well: editing sm90.cuh
    builds anew."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-Xptxas -v" in flags and "-lcuda" not in flags
    assert "flash_attn.cu" in _build.SOURCES
    assert (_build.CSRC / "sm90.cuh").is_file()
    assert (_build.CSRC / "tf32x3.cuh").is_file()
    source = (_build.CSRC / "flash_attn.cu").read_text()
    assert '#include "sm90.cuh"' in source
    assert '#include "tf32x3.cuh"' in source
    # Every kernel is an sm90 (bf16) or a three-pass TF32 (fp32) one; the
    # shared-memory template of the first port is gone.
    for kernel in _chip_smoke().FLASH_SYMBOLS:
        assert re.search(rf"__global__ .*\n?{kernel}\(", source), kernel
    for gone in ("fwd_kernel", "dkv_kernel", "dq_kernel", "FwdSmem",
                 "DkvSmem", "DqSmem", "wmma", "mma.h", "kTemplate"):
        assert not re.search(rf"\b{re.escape(gone)}\b", source), gone
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in (
        _build.CSRC / "tf32x3.cuh").read_text()
    (tmp_path / "k.cu").write_text("// kernel")
    (tmp_path / "h.cuh").write_text("// v1")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k.cu")
    assert _build.log_path("k.cu") == before.with_suffix(".log")
    (tmp_path / "h.cuh").write_text("// v2")
    assert _build.library_path("k.cu") != before


def test_ptxas_report_is_parsed():
    text = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2ns8fwd_sm90ILi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN2ns8fwd_sm90ILi128EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2ns7dq_tf32ILi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN2ns7dq_tf32ILi64EEEvNS_4ArgsE
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 2048 bytes smem, 400 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == [
        {"kernel": "_ZN2ns8fwd_sm90ILi128EEEv", "registers": 168, "smem": 0,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_ZN2ns7dq_tf32ILi64EEEvNS_4ArgsE", "registers": 40,
         "smem": 2048, "stack": 16, "spill_stores": 8, "spill_loads": 12},
    ]
    assert _build.parse_ptxas("") == []


def test_every_flash_kernel_is_held_to_no_spill():
    """Every flash kernel keeps its accumulators in registers, so the
    spill check of chip_smoke's build phase covers every symbol."""
    cs = _chip_smoke()
    assert set(cs.FLASH_SYMBOLS) <= set(cs.REGISTER_KERNELS)
    assert {"dq_sm90", "dq_tf32"} <= set(cs.FLASH_SYMBOLS)


def test_ptxas_rows_name_the_kernels_and_a_b2_spill_raises(monkeypatch):
    """chip_smoke names each ptxas entry by symbol and head-dim tile, and
    its build phase raises on a spill in B2 as in any flash kernel."""
    cs = _chip_smoke()
    row = {"registers": 200, "smem": 0, "stack": 0, "spill_stores": 0,
           "spill_loads": 0}
    report = [
        {**row, "kernel": "_ZN12_GLOBAL__N_17dq_sm90ILi128EEEv14CUtensorMap_st"},
        {**row, "kernel": "_ZN12_GLOBAL__N_17dq_tf32ILi64EEEvNS_4ArgsE"},
        {**row, "kernel": "_ZN12_GLOBAL__N_18dkv_sm90ILi64EEEv14CUtensorMap_st"},
    ]
    monkeypatch.setattr(_build, "ptxas_report", lambda source: report)
    monkeypatch.setattr(_build, "log_path",
                        lambda source: Path("/nonexistent/flash_attn.log"))
    assert [n for n, _ in cs.ptxas_rows(_build)] == [
        "dq_sm90<128>", "dq_tf32<64>", "dkv_sm90<64>"]
    cs.log_ptxas(_build)  # no spill: passes
    report[1]["spill_stores"] = 4
    with pytest.raises(AssertionError, match=r"dq_tf32<64>"):
        cs.log_ptxas(_build)


# ---- the fp32 kernels' numerics: three-pass TF32, emulated ------------------


def _chip_smoke():
    """chip_smoke.py of this checkout (its FLASH_TOL and _compare: the
    on-card check's limits), loaded by path."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32_attention(q, k, v, do, dl, causal, passes=3):
    """out, lse, dq, dk, dv with every tile product through
    ``tf32x3_matmul`` (``passes`` TF32 passes), as the fp32 kernels form
    them: O = (exp(S − m)·V) / l, P = exp(S − lse), dV = Pᵀ·dO, dP =
    dO·Vᵀ, dS = P∘(dP − δ′), dQ = scale·dS·K, dK = scale·dSᵀ·Q; softmax
    and sums in fp32. Inputs [B, T|S, H, D] fp32 tensors."""
    mm = lambda a, b: tflash.tf32x3_matmul(a, b, passes)  # noqa: E731
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = mm(qh, kh.transpose(-1, -2)) * scale
    if causal:
        T, S = s.shape[-2:]
        live = torch.arange(T)[:, None] + (S - T) >= torch.arange(S)[None, :]
        s = s.masked_fill(~live, -math.inf)
    m = s.amax(-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - shift)
    l = e.sum(-1, keepdim=True)
    out = mm(e, vh) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, shift + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, -math.inf))[..., 0]
    delta = (doh * out).sum(-1) - dl.transpose(1, 2)
    big = torch.full_like(lse, 0.5 * torch.finfo(torch.float32).max)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, big)[..., None])
    dv = mm(p.transpose(-1, -2), doh)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    return [x.transpose(1, 2) for x in (out, lse, dq, dk, dv)]


@pytest.mark.parametrize("x", [1.0, -3.5, 0.0, -0.0, 1 + 2**-10, 2.0**-126,
                               -(2 - 2**-10) * 2.0**127])
def test_tf32_round_keeps_exact_values(x):
    """A value with at most 10 mantissa bits is a TF32 value already
    (signed zero and the largest TF32 included)."""
    got = float(tflash.tf32_round(torch.tensor([x], dtype=torch.float32)))
    assert got == x and math.copysign(1.0, got) == math.copysign(1.0, x)


@pytest.mark.parametrize("x,want", [
    (1 + 2**-11, 1 + 2**-10),          # a tie: away from zero
    (-(1 + 2**-11), -(1 + 2**-10)),
    (1 + 3 * 2**-11, 1 + 2**-9),       # a tie with an odd last bit: away, too
    (1 + 2**-12, 1.0),                 # below half an ulp: down
    (1 + 2**-11 + 2**-20, 1 + 2**-10),  # above half an ulp: up
    (2 - 2**-12, 2.0),                 # the carry reaches the exponent
    (float(np.finfo(np.float32).max), math.inf),  # past the largest TF32
])
def test_tf32_round_rounds_to_nearest_ties_away(x, want):
    got = tflash.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want


def test_tf32_round_keeps_infinities_and_nan():
    x = torch.tensor([math.inf, -math.inf, math.nan])
    # A NaN whose payload sits in the low bits must not round to inf.
    x = torch.cat([x, torch.tensor([0x7F800001], dtype=torch.int32)
                   .view(torch.float32)])
    got = tflash.tf32_round(x)
    assert got[0] == math.inf and got[1] == -math.inf
    assert torch.isnan(got[2:]).all()


def test_tf32x3_matmul_error_per_pass():
    """Against float64: three passes keep ~2^-21 relative error, one pass
    ~2^-11, at D 128."""
    rng = np.random.default_rng(3)
    a, b = (torch.tensor(rng.standard_normal(s, dtype=np.float32))
            for s in ((64, 128), (128, 64)))
    exact = a.double() @ b.double()

    def rel(got):
        return float((got.double() - exact).norm() / exact.norm())

    assert rel(tflash.tf32x3_matmul(a, b)) < 4e-7
    assert rel(tflash.tf32x3_matmul(a, b, passes=1)) > 1e-4


@pytest.mark.parametrize("B,T,S,H,D,causal,block", CASES)
def test_tf32x3_attention_matches_jax_kernel(B, T, S, H, D, causal, block):
    """Attention whose every product is three-pass TF32 (what the fp32
    B1 and B3 compute) ≡ the Pallas kernels in interpret mode, forward
    and backward with a nonzero dLSE, within ATOL."""
    x = _inputs(T * 100 + S, B, T, S, H, D)
    got = _tf32_attention(*(torch.tensor(a) for a in x), causal)
    want = _jax_with_lse(*x, causal, block)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, ATOL)


def _tf32_vs_plain(passes):
    """_tf32_attention vs the plain fp32 attention and its autograd at
    B 1, T = S 256, H 2, D 128, causal, under chip_smoke's fp32 limits →
    {tensor: (within them, reading)}."""
    cs = _chip_smoke()
    q, k, v, do, dl = (torch.tensor(a) for a in _inputs(21, 1, 256, 256, 2, 128))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tflash.attention_with_lse_reference(*leaves, True)
    want = [out, lse, *torch.autograd.grad((out, lse), leaves, (do, dl))]
    got = _tf32_attention(q, k, v, do, dl, True, passes)
    names = ("out", "lse", "dq", "dk", "dv")
    return {n: cs._compare(torch, g, w, cs.FLASH_TOL["fp32"])
            for n, g, w in zip(names, got, want)}


def test_tf32x3_attention_meets_the_fp32_limits():
    """At a larger shape (B 1, T = S 256, H 2, D 128, causal) three-pass
    TF32 stays within FLASH_TOL["fp32"] (rel 1e-5, atol 1e-4) of the
    plain fp32 attention, the limits the kernels are held to on the card."""
    for name, (ok, text) in _tf32_vs_plain(3).items():
        assert ok, f"{name}: {text}"


def test_one_pass_tf32_fails_the_fp32_limits():
    """The control: one TF32 pass a product misses rel 1e-5 on every
    tensor, so the fp32 limits do tell one pass from three."""
    for name, (ok, text) in _tf32_vs_plain(1).items():
        assert not ok, f"{name}: {text}"


# ---- fp32 B2 (dq_tf32), emulated in its own tile order -------------------

DQ_CASES = [  # B, T, S, H, D, causal: ragged against the kernel's tiles
    (1, 40, 72, 2, 64, True),    # T < S, end-anchored
    (1, 72, 40, 2, 96, True),    # T > S: rows t < 32 have no live key
    (1, 40, 72, 2, 96, False),
    (1, 72, 40, 2, 64, False),
]


def _tf32_dq_tiled(q, k, v, do, lse, delta, causal, passes=3):
    """dq as fp32 B2 (dq_tf32) forms it, on [B, T|S, H, D] fp32 tensors:
    for each q-tile and each of its k-tiles (kernel_config's rows; k-tiles
    past the q-tile's last live key are not visited), S = Q·Kᵀ and dP =
    dO·Vᵀ through ``tf32x3_matmul`` (``passes`` TF32 passes), P = exp(S ·
    scale − lse) (0 where masked; a non-finite lse counts as 0.5·FLT_MAX)
    and dS = P∘(dP − δ′) in fp32, the tile's dS·K from zero, added to the
    running dQ in fp32; dQ · scale at the end."""
    cfg = tflash.kernel_config("flash_attn_dq", torch.float32, q.shape[-1])
    bq, bk = cfg["q_rows"], cfg["kv_rows"]
    mm = lambda a, b: tflash.tf32x3_matmul(a, b, passes)  # noqa: E731
    T, S, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = D**-0.5
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    big = torch.full_like(lse, 0.5 * torch.finfo(torch.float32).max)
    lse = torch.where(torch.isfinite(lse), lse, big).transpose(1, 2)
    dl = delta.transpose(1, 2)
    dq = torch.zeros_like(qh)
    for q0 in range(0, T, bq):
        rows = torch.arange(q0, min(q0 + bq, T))
        end = min(S, q0 + bq + S - T) if causal else S
        for k0 in range(0, max(end, 0), bk):
            keys = torch.arange(k0, min(k0 + bk, S))
            kt = kh[:, :, keys]
            s = mm(qh[:, :, rows], kt.transpose(-1, -2))
            dp = mm(doh[:, :, rows], vh[:, :, keys].transpose(-1, -2))
            p = torch.exp(s * scale - lse[:, :, rows, None])
            if causal:
                p = p.masked_fill(keys[None, :] > rows[:, None] + S - T, 0.0)
            ds = p * (dp - dl[:, :, rows, None])
            dq[:, :, rows] += mm(ds, kt)
    return (dq * scale).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _pallas_dq(case):
    """The Pallas forward (out, lse) and ``_dq_kernel``'s dq through
    ``_flash_backward`` in interpret mode (block 8 a side), with a nonzero
    dLSE → numpy inputs, lse, delta' and dq."""
    B, T, S, H, D, causal = case
    q, k, v, do, dl = _inputs(T * 1000 + S + D, B, T, S, H, D)
    jq, jk, jv, jdo, jdl = map(jnp.asarray, (q, k, v, do, dl))
    out, lse = jflash.flash_attention_with_lse(jq, jk, jv, causal, 8, 8, True)
    dq, _, _ = jflash._flash_backward(jq, jk, jv, out, lse, jdo, jdl,
                                      causal=causal, block_q=8, block_k=8,
                                      interpret=True)
    delta = (np.asarray(do) * np.asarray(out)).sum(-1) - dl
    return (q, k, v, do), np.asarray(lse), delta, np.asarray(dq)


def _tf32_dq_vs_pallas(case, passes):
    inputs, lse, delta, want = _pallas_dq(case)
    got = _tf32_dq_tiled(*(torch.tensor(a) for a in inputs), torch.tensor(lse),
                         torch.tensor(delta), case[-1], passes)
    cs = _chip_smoke()
    return cs._compare(torch, got, torch.tensor(want), cs.FLASH_TOL["fp32"])


@pytest.mark.parametrize("case", DQ_CASES)
def test_tf32_dq_tiled_matches_the_pallas_dq_kernel(case):
    """fp32 B2's arithmetic (three-pass TF32 products, one-tile chains
    over 32-key tiles added in fp32) ≡ the Pallas ``_dq_kernel`` in
    interpret mode, within the on-card limits FLASH_TOL["fp32"] (rel
    1e-5, atol 1e-4); rows with no live key give 0."""
    ok, text = _tf32_dq_vs_pallas(case, 3)
    assert ok, text
    _, T, S, _, _, causal = case
    if causal and T > S:
        _, _, _, want = _pallas_dq(case)
        assert (want[:, : T - S] == 0).all()


@pytest.mark.parametrize("case", DQ_CASES)
def test_one_pass_tf32_dq_fails_the_fp32_limits(case):
    """The control: with one TF32 pass a product, the same tile order
    misses FLASH_TOL["fp32"], so the limits tell one pass from three."""
    ok, text = _tf32_dq_vs_pallas(case, 1)
    assert not ok, text
