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
