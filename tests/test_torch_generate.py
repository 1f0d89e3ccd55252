"""ddp_tpu_torch.models + interop ≡ the JAX package, on the CPU.

Weights and inputs are made with numpy from a seed (a JAX-layout
parameter tree, biases and LayerNorm parameters random too, so every
leaf's mapping matters) and handed to both packages: JAX gets the tree
as it is, the port gets it through ``lm_params_from_jax``.

Tolerances: 1e-4 on whole-model logits and 1e-5 on single cache rows —
fp32 sums taken in another order by each framework. int8 cache rows
may differ by one quantization step where a row value sits on a
rounding boundary that the fp32 noise moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import generate as jgen
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.models.lm import dense_lm_apply
from ddp_tpu.ops.decode import quantize_kv as jquantize
from ddp_tpu_torch.interop.jax_params import flatten_tree, lm_params_from_jax
from ddp_tpu_torch.models import generate as tgen
from ddp_tpu_torch.models.lm import CausalLM, LMSpec

LOGITS_ATOL = 1e-4  # whole-model fp32 logits, cross-framework sums
ROW_ATOL = 1e-5  # single K/V rows
VOCAB, TOTAL_LEN, D, DEPTH, HEADS = 64, 64, 32, 2, 4


def numpy_lm_tree(spec: JSpec, seed: int = 0) -> dict:
    """A dense causal-LM tree in the JAX layout, made with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def nrm(shape, std):
        return (rng.standard_normal(shape) * std).astype(f32)

    d = spec.d_model
    h_kv = spec.num_kv_heads or spec.num_heads
    cols = (spec.num_heads + 2 * h_kv) * (d // spec.num_heads)
    mlp = d * spec.mlp_ratio

    def dense(n_in, n_out):
        return {"kernel": nrm((n_in, n_out), n_in**-0.5),
                "bias": nrm((n_out,), 0.1)}

    def norm():
        return {"scale": 1.0 + nrm((d,), 0.1), "bias": nrm((d,), 0.1)}

    tree = {
        "embed": nrm((spec.vocab_size, d), 0.3),
        "pos_embed": nrm((1, spec.total_len, d), 0.3),
        "ln_final": norm(),
    }
    for i in range(spec.depth):
        tree[f"block{i + 1}"] = {
            "ln1": norm(),
            "attn": {"qkv": dense(d, cols), "proj": dense(d, d)},
            "ln2": norm(),
            "mlp1": dense(d, mlp),
            "mlp2": dense(mlp, d),
        }
    return tree


def make_pair(kv_heads: int = 0, total_len: int = TOTAL_LEN, seed: int = 0):
    """(JAX spec, JAX params, port model) over the same numpy weights."""
    jspec = JSpec(vocab_size=VOCAB, total_len=total_len, d_model=D,
                  depth=DEPTH, num_heads=HEADS, num_kv_heads=kv_heads)
    tree = numpy_lm_tree(jspec, seed)
    spec, state = lm_params_from_jax(tree, num_heads=HEADS)
    model = CausalLM.from_state(spec, state, "cpu")
    return jspec, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_causal_lm_logits_match_dense_lm_apply(kv_heads):
    jspec, jparams, model = make_pair(kv_heads)
    assert model.spec == LMSpec(VOCAB, TOTAL_LEN, D, DEPTH, HEADS, kv_heads)
    tokens = np.random.default_rng(1).integers(0, VOCAB, (2, 40))
    want = np.asarray(dense_lm_apply(jspec, jparams, jnp.asarray(tokens)))
    got = model(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 40, VOCAB)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_interop_flat_keys_and_rejections():
    """A flat '/'-keyed tree (an .npz) maps like the nested one; MoE
    subtrees, missing blocks and missing or extra leaves raise."""
    jspec = JSpec(VOCAB, TOTAL_LEN, D, 3, HEADS, num_kv_heads=2)
    tree = numpy_lm_tree(jspec)
    spec, state = lm_params_from_jax(tree, num_heads=HEADS)
    spec2, state2 = lm_params_from_jax(flatten_tree(tree), num_heads=HEADS)
    assert spec == spec2 and spec.depth == 3 and spec.num_kv_heads == 2
    assert state.keys() == state2.keys()
    assert all(np.array_equal(state[k], state2[k]) for k in state)
    assert state["block2.attn.qkv.weight"].shape == (64, D)  # [out, in]
    np.testing.assert_array_equal(
        state["block2.attn.qkv.weight"], tree["block2"]["attn"]["qkv"]["kernel"].T
    )

    moe = dict(tree, block2={**tree["block2"], "moe": {"wi": np.zeros(2)}})
    with pytest.raises(ValueError, match="moe"):
        lm_params_from_jax(moe, num_heads=HEADS)
    gap = {k: v for k, v in tree.items() if k != "block2"}
    with pytest.raises(ValueError, match="block1..blockN"):
        lm_params_from_jax(gap, num_heads=HEADS)
    flat = flatten_tree(tree)
    missing = {k: v for k, v in flat.items() if k != "block3/mlp2/bias"}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax(missing, num_heads=HEADS)
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_jax(dict(flat, extra=np.zeros(1)), num_heads=HEADS)
    with pytest.raises(ValueError, match="does not divide"):
        lm_params_from_jax(tree, num_heads=5)


def _random_caches(spec_j, kv_dtype, slots, pos, seed=3):
    """The same random cache contents as a JAX and a port SlotCache."""
    rng = np.random.default_rng(seed)
    h_kv = spec_j.num_kv_heads or spec_j.num_heads
    shape = (spec_j.depth, slots, spec_j.total_len, h_kv, D // HEADS)
    kf = rng.standard_normal(shape, dtype=np.float32)
    vf = rng.standard_normal(shape, dtype=np.float32)
    pos = np.asarray(pos, np.int32)
    if kv_dtype == "int8":
        k, ks = (np.asarray(a) for a in jquantize(jnp.asarray(kf)))
        v, vs = (np.asarray(a) for a in jquantize(jnp.asarray(vf)))
        jc = jgen.SlotCache(*map(jnp.asarray, (k, v, pos, ks, vs)))
        tc = tgen.SlotCache(*(torch.from_numpy(a.copy())
                              for a in (k, v, pos, ks, vs)))
    else:
        jc = jgen.SlotCache(*map(jnp.asarray, (kf, vf, pos)))
        tc = tgen.SlotCache(*(torch.from_numpy(a.copy()) for a in (kf, vf, pos)))
    return jc, tc


def _assert_cache_close(tc, jc):
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    if tc.quantized():
        dq = np.abs(tc.k.numpy().astype(np.int32) - np.asarray(jc.k, np.int32))
        dv = np.abs(tc.v.numpy().astype(np.int32) - np.asarray(jc.v, np.int32))
        assert dq.max() <= 1 and dv.max() <= 1  # one rounding step
        assert (dq > 0).mean() < 1e-3 and (dv > 0).mean() < 1e-3
        np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale),
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale),
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ROW_ATOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ROW_ATOL)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_slot_decode_step_matches_jax(kv_heads, kv_dtype):
    """Mixed per-slot positions, an idle lane at pos 0 and one parked
    at the position ceiling: logits, written cache rows and pos."""
    jspec, jparams, model = make_pair(kv_heads)
    pos = [0, 5, 17, TOTAL_LEN]
    jc, tc = _random_caches(jspec, kv_dtype, 4, pos)
    tokens = np.asarray([3, 60, 7, 11], np.int32)
    jl, jc2 = jgen.slot_decode_step(jspec, jparams, jc, jnp.asarray(tokens))
    tl = tgen.slot_decode_step(model, tc, torch.from_numpy(tokens))
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
    assert tc.pos.tolist() == [1, 6, 18, TOTAL_LEN]
    _assert_cache_close(tc, jc2)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefill_chunk_first_and_continuation_match_jax(kv_dtype):
    """A first chunk (self-attending) then a continuation chunk
    (attending the lane under the banded mask): cache lines, pos and
    the first token, GQA so the kv grouping is exercised."""
    jspec, jparams, model = make_pair(2)
    S = 3
    jc, tc = _random_caches(jspec, kv_dtype, S, [0, 0, 0])
    prompt = np.random.default_rng(5).integers(0, VOCAB, 13)
    jstate = [jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.int32),
              jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.float32),
              jnp.ones(S, jnp.float32)]
    tstate = [torch.zeros(S, dtype=torch.int64) for _ in range(3)] + [
        torch.zeros(S), torch.ones(S)]
    # (start, width, live, final, lane_attend)
    for start, width, live, final in ((0, 8, 8, False), (8, 8, 5, True)):
        buf = np.zeros(width, np.int32)
        buf[:live] = prompt[start:start + live]
        jout = jgen.prefill_chunk(
            jspec, jparams, jc, *jstate, jnp.int32(1), jnp.asarray(buf),
            jnp.int32(start), jnp.int32(live), jnp.asarray(final),
            jnp.int32(9), jnp.float32(0.0), jnp.float32(1.0),
            lane_attend=start != 0,
        )
        jc, jstate, jfirst = jout[0], list(jout[1:6]), jout[6]
        tfirst = tgen.prefill_chunk(
            model, tc, *tstate, 1, torch.from_numpy(buf).long(), start,
            live, final, 9, 0.0, 1.0, lane_attend=start != 0,
        )
        _assert_cache_close(tc, jc)
        assert tc.pos.tolist() == [0, start + live, 0]
        for t, j in zip(tstate, jstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        if final:
            assert int(tfirst) == int(jfirst) == int(tstate[0][1])
        else:
            assert tfirst is None


def test_nucleus_filter_matches_jax_exactly():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, VOCAB)) * 2).astype(np.float32)
    top_ps = np.asarray([0.05, 0.3, 0.5, 0.9, 0.99, 0.999], np.float32)
    got = tgen.nucleus_filter(torch.from_numpy(logits), torch.from_numpy(top_ps))
    for row, p, g in zip(logits, top_ps, got.numpy()):
        want = np.asarray(jgen.nucleus_filter(jnp.asarray(row), jnp.float32(p)))
        np.testing.assert_array_equal(g, want)


def _sample(logits, seeds, steps, temps, top_ps):
    return tgen.sample_slot_tokens(
        torch.as_tensor(np.asarray(logits, np.float32)),
        torch.as_tensor(np.asarray(seeds, np.int64)),
        torch.as_tensor(np.asarray(steps, np.int64)),
        torch.as_tensor(np.asarray(temps, np.float32)),
        torch.as_tensor(np.asarray(top_ps, np.float32)),
    ).tolist()


def test_seeded_draw_depends_only_on_its_own_seed_and_step():
    """Lane 0's token at (seed, step) is the same whatever the other
    lanes hold and however many there are — the property a seeded
    stream (and later speculative decoding) relies on."""
    rng = np.random.default_rng(4)
    row = rng.standard_normal(VOCAB) * 2
    for step in range(20):
        alone = _sample([row], [-7], [step], [0.9], [0.8])[0]
        others = rng.standard_normal((5, VOCAB)) * 3
        mixed = _sample(
            np.vstack([row, others]), [-7, 1, 2, 3, 4, 5],
            [step, 0, 9, step, 3, 1], [0.9, 1.0, 0.0, 2.0, 0.5, 1.0],
            [0.8, 1.0, 1.0, 0.5, 0.9, 1.0],
        )[0]
        assert alone == mixed


def test_temperature_zero_is_greedy_and_draws_stay_in_nucleus():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((16, VOCAB)) * 2
    greedy = logits.argmax(-1).tolist()
    assert _sample(logits, range(16), [3] * 16, [0.0] * 16, [1.0] * 16) == greedy
    temp, top_p = 1.5, 0.6
    for step in range(10):
        toks = _sample(logits, range(16), [step] * 16, [temp] * 16,
                       [top_p] * 16)
        for row, tok in zip(logits, toks):
            kept = np.asarray(jgen.nucleus_filter(
                jnp.asarray(row / temp, jnp.float32), jnp.float32(top_p)))
            # JAX masks what it drops to finfo.min / 2.
            assert kept[tok] > np.finfo(np.float32).min / 4, (
                "drew outside JAX's nucleus")


def test_draws_follow_softmax_chi_square():
    """Vocab 8, 4000 draws at consecutive steps: the empirical counts
    match softmax(logits / T) (chi-square, 7 dof, critical value 24.32
    at alpha 0.001 — deterministic here, the seed is fixed)."""
    logits = np.asarray([0.5, -1.0, 2.0, 0.0, 1.0, -0.5, 0.3, 1.5])
    T, N = 0.8, 4000
    toks = _sample(np.tile(logits, (N, 1)), [12345] * N, np.arange(N),
                   [T] * N, [1.0] * N)
    counts = np.bincount(toks, minlength=8)
    p = np.exp(logits / T) / np.exp(logits / T).sum()
    chi2 = ((counts - N * p) ** 2 / (N * p)).sum()
    assert chi2 < 24.32, (chi2, counts, N * p)
