"""ddp_tpu_torch.ops: the port's decode/prefill attention ≡ the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port (``device="cpu"``). JAX's Pallas
flash-decode kernel runs as tests/test_flash_decode.py runs it on the
CPU, with ``interpret=True``. On a CPU tensor the port's kernel wrapper
takes the plain version (there is no kernel to launch here), so the
kernel itself is held against the plain version on the card by
chip_smoke.py.

Tolerances: fp32 atol/rtol 1e-5 for single ops — the frameworks sum in
different orders, which moves fp32 results by a few ulps.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops import attention as jattn
from ddp_tpu.ops import decode as jdec
from ddp_tpu_torch import resolve_device
from ddp_tpu_torch.ops import _build
from ddp_tpu_torch.ops import attention as tattn
from ddp_tpu_torch.ops import decode as tdec

ATOL = RTOL = 1e-5  # fp32 single op, cross-framework summation order
REPO = Path(__file__).resolve().parent.parent


def _qkv(seed, S, H, H_kv, Dh, L):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, Dh), dtype=np.float32)
    k = rng.standard_normal((S, L, H_kv, Dh), dtype=np.float32)
    v = rng.standard_normal((S, L, H_kv, Dh), dtype=np.float32)
    pos = rng.integers(0, L, size=S).astype(np.int32)
    pos[0], pos[-1] = 0, L - 1
    return q, k, v, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "S,H,H_kv,Dh,L,block_k",
    [
        (3, 4, 4, 8, 16, 8),    # MHA, two key blocks
        (2, 8, 2, 16, 32, 8),   # GQA group 4, four blocks
        (4, 4, 2, 8, 24, 16),   # block_k does not divide L
        (1, 2, 1, 4, 8, 128),   # block_k > L
    ],
)
def test_plain_matches_jax_reference_and_pallas(S, H, H_kv, Dh, L, block_k):
    """The port's plain version ≡ JAX's reference AND its Pallas kernel
    (interpret mode), at every lane position incl. 0 and L-1."""
    q, k, v, pos = _qkv(S * 100 + L, S, H, H_kv, Dh, L)
    got = tdec.decode_attention_reference(*_t(q, k, v, pos)).numpy()
    ref = np.asarray(jdec.decode_attention_reference(*_j(q, k, v, pos)))
    fl = np.asarray(
        jdec.flash_decode_attention(
            *_j(q, k, v, pos), block_k=block_k, interpret=True
        )
    )
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, fl, atol=ATOL, rtol=RTOL)


def test_unaligned_positions_and_idle_ceiling():
    """Keys past pos[s] contribute nothing (poisoned rows above the
    band leave the output unchanged), and a lane parked at the
    position ceiling (pos == L) attends every key, as in JAX."""
    q, k, v, _ = _qkv(7, 4, 4, 2, 8, 16)
    pos = np.asarray([0, 5, 11, 16], np.int32)
    out = tdec.decode_attention_reference(*_t(q, k, v, pos))
    ref = np.asarray(jdec.decode_attention_reference(*_j(q, k, v, pos)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    rng = np.random.default_rng(8)
    live = np.arange(16)[None, :, None, None] <= pos[:, None, None, None]
    poison = rng.standard_normal(k.shape, dtype=np.float32) * 100
    k2 = np.where(live, k, poison)
    v2 = np.where(live, v, poison)
    out2 = tdec.decode_attention_reference(*_t(q, k2, v2, pos))
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=ATOL, rtol=RTOL)


def test_int8_path_matches_jax():
    """int8 K/V + scales: the port's plain version ≡ JAX's reference
    and Pallas kernel over the SAME quantized cache."""
    q, k, v, _ = _qkv(11, 3, 4, 2, 8, 16)
    pos = np.asarray([2, 7, 15], np.int32)
    qk, ks = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(k)))
    qv, vs = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(v)))
    got = tdec.decode_attention_reference(*_t(q, qk, qv, pos, ks, vs))
    ref = jdec.decode_attention_reference(*_j(q, qk, qv, pos, ks, vs))
    fl = jdec.flash_decode_attention(
        *_j(q, qk, qv, pos, ks, vs), block_k=8, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(fl), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_quantize_kv_matches_jax(scale):
    """int8 values exactly, scales to 1e-7 relative; zero rows stay
    exact zeros (the amax floor)."""
    rng = np.random.default_rng(int(scale * 100))
    x = (rng.standard_normal((4, 16, 2, 8)) * scale).astype(np.float32)
    x[0, 3] = 0.0
    # amax 127 → scale exactly 1: exact .5 ties, which round half to even.
    x[1, 2, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    tq, ts = tdec.quantize_kv(torch.from_numpy(x))
    jq, js = jdec.quantize_kv(jnp.asarray(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    back = tdec.dequantize_kv(tq, ts).numpy()
    np.testing.assert_array_equal(back[0, 3], 0.0)
    np.testing.assert_allclose(
        back, np.asarray(jdec.dequantize_kv(jq, js)), rtol=1e-7, atol=0
    )


def test_cpu_tensor_takes_plain_version_without_launch():
    """On a CPU tensor the kernel wrapper returns the plain version's
    result and counts no launch; ``auto`` resolves to the plain version
    on the CPU; an unknown impl raises."""
    q, k, v, pos = _t(*_qkv(3, 2, 4, 2, 8, 16))
    before = dict(tdec.flash_decode_attention.launches)
    out = tdec.flash_decode_attention(q, k, v, pos)
    ref = tdec.decode_attention_reference(q, k, v, pos)
    assert torch.equal(out, ref)
    assert tdec.flash_decode_attention.launches == before
    assert set(before) == {"flash_decode_fp32", "flash_decode_int8"}
    assert torch.equal(tdec.decode_attention(q, k, v, pos, impl="auto"), ref)
    assert torch.equal(tdec.decode_attention(q, k, v, pos, impl="flash"), ref)
    assert tdec.resolve_impl("auto", torch.device("cpu")) == "reference"
    assert tdec.resolve_impl("auto", torch.device("cuda")) == "flash"
    with pytest.raises(ValueError, match="impl"):
        tdec.decode_attention(q, k, v, pos, impl="dense")


# ---- the kernel's split (split-K over the cache), emulated ------------


@pytest.mark.parametrize(
    "S,H,H_kv,Dh,L,chunk,quantized",
    [
        (4, 4, 4, 8, 40, 8, False),    # ragged L: 5 chunks, the last short
        (4, 8, 2, 16, 32, 4, False),   # GQA group 4, 8 chunks
        (4, 4, 2, 8, 24, 64, False),   # one chunk wider than L
        (4, 4, 4, 16, 48, 16, True),   # int8 K/V
        (4, 8, 2, 8, 37, 5, True),     # int8, GQA, ragged, 8 chunks
    ],
)
def test_split_emulation_matches_jax_and_reference(
        S, H, H_kv, Dh, L, chunk, quantized):
    """The kernel's algorithm — per-chunk partials (o, lse) merged in chunk
    order — ≡ JAX's Pallas flash-decode kernel (interpret mode) and the
    plain version, with lanes at pos 0 (every later chunk wholly past the
    band), inside the first chunk, L-1 and L (the idle ceiling)."""
    q, k, v, pos = _qkv(S * 1000 + L * 10 + chunk, S, H, H_kv, Dh, L)
    pos[:4] = 0, min(chunk, L) // 2, L - 1, L
    scales = ()
    if quantized:
        k, ks = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(v)))
        scales = (ks, vs)
    got = tdec.decode_attention_split_reference(
        *_t(q, k, v, pos, *scales), chunk=chunk).numpy()
    ref = tdec.decode_attention_reference(*_t(q, k, v, pos, *scales))
    fl = jdec.flash_decode_attention(
        *_j(q, k, v, pos, *scales), block_k=8, interpret=True)
    np.testing.assert_allclose(got, ref.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(fl), atol=ATOL, rtol=RTOL)


def test_split_partials_of_dead_chunks_and_the_merge():
    """A chunk wholly past a lane's band is empty (lse −inf, o 0) and
    weighs nothing; dropping a live chunk from the merge changes the
    result (the chip check's negative control); and the merge of two
    chunks is ``parallel/ring.combine_attention_partials``."""
    from ddp_tpu_torch.parallel.ring import combine_attention_partials

    q, k, v, pos = _t(*_qkv(21, 3, 4, 2, 8, 16))
    pos = torch.tensor([0, 9, 15], dtype=torch.int32)
    o, lse = tdec.decode_split_partials(q, k, v, pos, chunk=8)
    assert o.shape == (3, 4, 2, 8) and lse.shape == (3, 4, 2)
    assert torch.isinf(lse[0, :, 1]).all() and (o[0, :, 1] == 0).all()
    assert torch.isfinite(lse[1:]).all()
    ref = tdec.decode_attention_reference(q, k, v, pos)
    merged = tdec.merge_split_partials(o, lse)
    torch.testing.assert_close(merged, ref, atol=ATOL, rtol=RTOL)
    o2, l2 = combine_attention_partials(o[..., 0, :], lse[..., 0],
                                        o[..., 1, :], lse[..., 1])
    torch.testing.assert_close(merged, o2, atol=1e-6, rtol=0)
    dropped = lse.clone()
    dropped[..., 0] = -torch.inf
    assert (tdec.merge_split_partials(o, dropped) - ref).abs().max() > 1e-2


# ---- which shapes the kernel takes, and how it splits them ------------


@pytest.mark.parametrize(
    "Dh,fp32,int8",
    [
        (8, True, False),     # two float4; not a whole int8 vector
        (24, True, False),    # six float4; 24 % 16 != 0
        (128, True, True),    # the serving model
        (144, True, True),    # R = 16 threads a row, 9 of them loading
        (256, True, True),    # the widest row (R = 16)
        (320, False, False),  # past MAX_HEAD_DIM
    ],
)
def test_kernel_takes_per_head_dim(Dh, fp32, int8):
    """B4 takes fp32 K/V at Dh % 4 == 0, B5 int8 at Dh % 16 == 0, both up
    to 256; the answer for each head dim is stated above. ``auto``
    resolves to the plain version on the card where it is false, and an
    explicit ``flash`` raises there."""
    assert tdec.kernel_takes(8, 8, Dh, torch.float32) is fp32
    assert tdec.kernel_takes(8, 2, Dh, torch.int8) is int8
    cuda = torch.device("cuda")
    for dtype, taken in ((torch.float32, fp32), (torch.int8, int8)):
        shape = (8, 8, Dh, dtype)
        want = "flash" if taken else "reference"
        assert tdec.resolve_impl("auto", cuda, shape) == want
        assert tdec.resolve_impl("auto", torch.device("cpu"), shape) == "reference"
        assert tdec.resolve_impl("reference", cuda, shape) == "reference"
        if taken:
            assert tdec.resolve_impl("flash", cuda, shape) == "flash"
        else:
            with pytest.raises(ValueError, match="does not take"):
                tdec.resolve_impl("flash", cuda, shape)


def test_kernel_takes_heads_dtypes_and_strides():
    """H must be a multiple of H_kv, K/V fp32 or int8, the last dim
    contiguous and every row on a 16-byte boundary; ``_tensors_take``
    adds q fp32 and K/V strides equal."""
    take = tdec.kernel_takes
    assert not take(6, 4, 128, torch.float32)
    assert not take(8, 8, 128, torch.bfloat16)
    L, H_kv, Dh = 16, 2, 128
    cont = (L * H_kv * Dh, H_kv * Dh, Dh, 1)
    assert take(8, H_kv, Dh, torch.float32, cont)
    assert take(8, H_kv, Dh, torch.int8, cont)
    assert not take(8, H_kv, Dh, torch.float32, cont[:3] + (2,))
    assert not take(8, H_kv, Dh, torch.float32, (cont[0], cont[1] + 1, Dh, 1))
    assert take(8, H_kv, Dh, torch.float32, (cont[0], cont[1] + 4, Dh, 1))
    assert not take(8, H_kv, Dh, torch.int8, (cont[0], cont[1] + 4, Dh, 1))
    q, k, v, _ = _t(*_qkv(5, 2, 4, 2, 8, 16))
    assert tdec._tensors_take(q, k, v)
    assert not tdec._tensors_take(q.double(), k, v)
    assert not tdec._tensors_take(q, k, v.clone().transpose(1, 2)
                                  .contiguous().transpose(1, 2))
    # One layer of a [depth, S, L, H_kv, Dh] cache, as the engine passes it.
    cache = torch.zeros(2, 2, 16, 2, 8)
    assert tdec._tensors_take(q, cache[1], cache[1])


@pytest.mark.parametrize(
    "L,dtype,Dh,pairs,want",
    [
        (256, torch.float32, 128, 64, (64, 4)),     # serving: 256 CTAs
        (8192, torch.float32, 128, 64, (512, 16)),  # long cache: 1024
        (256, torch.int8, 128, 64, (256, 1)),       # 64 KB: no split
        (8192, torch.int8, 128, 64, (1664, 5)),     # all CTAs resident
        (200, torch.float32, 128, 64, (64, 4)),     # ragged: last chunk 8
        (256, torch.float32, 128, 2048, (256, 1)),  # many lanes: no split
        (256, torch.float32, 64, 64, (128, 2)),     # R 4: 64-key tiles
    ],
)
def test_split_plan(L, dtype, Dh, pairs, want):
    """Chunks are whole tiles (kKeys x 128 / R keys: 2 keys a row group
    in fp32, 4 in int8), as many as give ~SPLIT_CTAS_PER_SM CTAs per SM
    (8 in fp32, 2 in int8) on a 132-SM H100 but each of at least
    MIN_CHUNK_BYTES of K and V, and the chunks cover L."""
    tile = tdec.tile_keys(dtype, Dh)
    chunk, n = tdec.split_plan(L, pairs, 132, dtype, Dh)
    assert (chunk, n) == want
    assert chunk % tile == 0 and (n - 1) * chunk < L <= n * chunk
    assert tdec.threads_a_row(Dh) * 16 >= Dh
    assert [tdec.group_tile(g) for g in (1, 2, 3, 4, 8)] == [1, 2, 4, 4, 4]


@pytest.mark.parametrize(
    "T,S,q_offset", [(6, 6, None), (4, 10, None), (4, 16, 3), (8, 16, 0)]
)
def test_prefill_attention_matches_jax(T, S, q_offset):
    """dot_product_attention (the chunked-prefill attention): causal,
    end-anchored, and banded by a q_offset, ≡ JAX's."""
    rng = np.random.default_rng(T * S)
    q = rng.standard_normal((2, T, 4, 8), dtype=np.float32)
    k = rng.standard_normal((2, S, 4, 8), dtype=np.float32)
    v = rng.standard_normal((2, S, 4, 8), dtype=np.float32)
    got = tattn.dot_product_attention(
        *_t(q, k, v), causal=True, q_offset=q_offset
    )
    want = jattn.dot_product_attention(
        *_j(q, k, v), causal=True, q_offset=q_offset
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert tattn.MASK_VALUE == float(jattn.MASK_VALUE)


def test_resolve_device_never_falls_back_to_cpu():
    """No GPU here: the default raises, an explicit CUDA device raises,
    and only an explicit "cpu" gives the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for GPU-less hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_is_keyed_by_source_and_names_missing_nvcc(monkeypatch):
    """The kernel library path is keyed by a hash of its source (an
    edited kernel builds anew), lives in the ignored build directory,
    and a host without nvcc gets a clear error, not a crash."""
    path = _build.library_path("flash_decode.cu")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("flash_decode.cu")
    assert path.name.startswith("flash_decode-") and path.suffix == ".so"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "ddp_tpu_torch/ops/_build/" in ignored
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import without pulling in
    jax or any ddp_tpu module (a fresh interpreter)."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "ddp_tpu_torch").rglob("*.py")
    )
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import ddp_tpu_torch.native as native\n"
        "assert native._LIB is None and not native._TRIED, 'built at import'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'ddp_tpu' or "
        "m.startswith('ddp_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ddp_tpu_torch.serve.__main__" in mods
    assert "ddp_tpu_torch.serve.pages" in mods  # the PrefixCache copy
    assert "ddp_tpu_torch.serve.lifecycle" in mods  # the reasons, the token
    assert "ddp_tpu_torch.serve.programs" in mods  # the step programs
    for m in ("models.resnet", "models.vit", "data.cifar", "data.augment",
              "interop.jax_params"):  # the image families' modules
        assert f"ddp_tpu_torch.{m}" in mods
    for m in ("tracer", "reqtrace", "slo", "recorder", "promtext"):
        assert f"ddp_tpu_torch.obs.{m}" in mods  # serving observability
    for m in ("runtime.consensus", "runtime.chaos", "runtime.launch",
              "utils.watchdog", "interop.torch_checkpoint",
              "interop.import_torch_checkpoint"):  # the fault-tolerance layer
        assert f"ddp_tpu_torch.{m}" in mods
    for m in ("data.imagenet", "data.ppm", "data.preprocess_imagenet",
              "native", "models.remat"):  # the ImageNet family
        assert f"ddp_tpu_torch.{m}" in mods
    for m in ("data.bpe", "data.sequences", "models.seq_transformer",
              "parallel.ring"):  # LM breadth and the long-context model
        assert f"ddp_tpu_torch.{m}" in mods
