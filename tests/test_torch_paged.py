"""ddp_tpu_torch's paged serving ≡ the JAX package's, on the CPU.

The port's copy of ``serve/pages.py``, its paged decode attention
(``ops/decode``), its paged cache (``models/generate.PagedSlotCache``) and
its paged engine are held against the JAX package on the same seeded
inputs, at ``tests/test_paged.py``'s size (vocab 37, total_len 32, d 32,
depth 2, 4 heads; GQA with 2 KV heads too). Weights are made with numpy
and reach the port through ``interop.jax_params.lm_params_from_jax``.

- ``PrefixCache``: the two copies take the same seeded sequence of
  acquire / release / match / adopt operations and return the same page
  ids, hits and stats; ``check_invariants`` holds after every operation.
- Paged decode attention: the port's plain paged version ≡ JAX's
  ``paged_decode_attention`` (``impl="reference"``, and the Pallas kernel
  in interpret mode), fp32 and int8 pools, shuffled tables with pages
  shared between lanes and scratch entries past each lane's demand;
  atol/rtol 1e-5 (fp32, cross-framework summation order). It is bitwise
  the port's fixed-lane plain version over ``gather_paged_kv``. On a CPU
  tensor the kernel wrappers launch nothing.
- The paged decode step and prefill chunk ≡ JAX's over the same pool
  (logits 1e-4, rows 1e-5, int8 rows within one quantization step), apart
  from writes past a lane's table end: JAX drops them, the port writes
  them to the scratch page 0, which no live position reads.
- The paged engine's greedy streams are token-identical to the JAX paged
  engine's (bucket and page edges, a forked prefix pair, LRU eviction, a
  page-starved bind), int8 paged ≡ int8 fixed-lane, seeded paged ≡ seeded
  fixed-lane, and the shared prefix pages keep their bytes while other
  lanes decode between a hit's chunks. Every greedy stream checks that
  its top-2 logit gap exceeds 1e-4 at each emitted token.
"""

import functools
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import generate as jgen
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.ops import decode as jdec
from ddp_tpu.serve import pages as jpages
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu_torch.interop.jax_params import lm_params_from_jax
from ddp_tpu_torch.models import generate as tgen
from ddp_tpu_torch.models.lm import CausalLM
from ddp_tpu_torch.ops import decode as tdec
from ddp_tpu_torch.serve import pages as tpages
from ddp_tpu_torch.serve.__main__ import main as serve_main
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.serve.server import LMServer
from test_torch_generate import numpy_lm_tree
from test_torch_serve import _assert_gaps

ATOL = RTOL = 1e-5  # fp32 single op, cross-framework summation order
LOGITS_ATOL = 1e-4  # whole-model fp32 logits
VOCAB, TOTAL_LEN, D, DEPTH, HEADS = 37, 32, 32, 2, 4


@functools.lru_cache(maxsize=None)
def pair(kv_heads: int = 0):
    """(JAX spec, JAX params, port model) over the same numpy weights."""
    jspec = JSpec(vocab_size=VOCAB, total_len=TOTAL_LEN, d_model=D,
                  depth=DEPTH, num_heads=HEADS, num_kv_heads=kv_heads)
    tree = numpy_lm_tree(jspec, seed=0)
    spec, state = lm_params_from_jax(tree, num_heads=HEADS)
    model = CausalLM.from_state(spec, state, "cpu")
    return jspec, _jax_tree(tree), model


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# ---- the prefix cache --------------------------------------------------


def _both(num_pages, page_size):
    return (tpages.PrefixCache(num_pages, page_size),
            jpages.PrefixCache(num_pages, page_size))


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_prefix_cache_property_matches_jax(seed):
    """test_paged.py's 300-operation property test, driven on both copies
    at once (plus adopt and bare match): same results and stats after
    every operation, invariants on both, nothing leaked at the end."""
    rng = np.random.default_rng(seed)
    ps, total = 4, 32
    ours, theirs = _both(24, ps)
    prefixes = [[int(t) for t in rng.integers(0, 50, 12)] for _ in range(3)]
    live = []  # (tokens, pids, prefilled)
    for _ in range(300):
        op = rng.random()
        pre = prefixes[int(rng.integers(0, len(prefixes)))]
        tail = [int(t) for t in rng.integers(0, 50, int(rng.integers(1, 6)))]
        tokens = pre + tail
        if op < 0.5 and len(live) < 5:
            n_new = int(rng.integers(1, 8))
            demand = tpages.page_demand(len(tokens), n_new, ps,
                                        total_len=total)
            assert demand == jpages.page_demand(len(tokens), n_new, ps,
                                                total_len=total)
            got = ours.acquire(tokens, demand)
            assert got == theirs.acquire(tokens, demand)
            if got is not None:
                pids, matched = got
                assert len(pids) == demand and matched % ps == 0
                assert matched <= len(tokens) - 1
                live.append((tokens, pids, len(tokens)))
        elif op < 0.6:
            assert ours.adopt(tokens) == theirs.adopt(tokens)
        elif op < 0.7:
            cap = int(rng.integers(0, 5))
            assert ours.match(tokens, cap) == theirs.match(tokens, cap)
        elif live:
            tokens, pids, prefilled = live.pop(int(rng.integers(0, len(live))))
            if rng.random() < 0.2:  # mid-prefill eviction path
                prefilled = int(rng.integers(0, len(tokens)))
            ours.release(tokens, pids, prefilled)
            theirs.release(tokens, pids, prefilled)
        ours.check_invariants()
        theirs.check_invariants()
        assert ours.stats() == theirs.stats()
        assert (ours.shared_pages, ours.mapped_pages, ours.mapped_page_refs,
                ours.hit_rate()) == (theirs.shared_pages, theirs.mapped_pages,
                                     theirs.mapped_page_refs,
                                     theirs.hit_rate())
    for tokens, pids, prefilled in live:
        ours.release(tokens, pids, prefilled)
        theirs.release(tokens, pids, prefilled)
    ours.check_invariants()
    assert ours.stats() == theirs.stats()
    assert ours.mapped_pages == 0
    assert ours.free_pages + ours.cached_pages == ours.num_pages - 1


def test_prefix_cache_pins_and_starvation_match_jax():
    """test_paged.py's allocator cases on both copies: a matched prefix is
    never evicted by its own acquire; a doomed acquire evicts nothing;
    only full prefilled prompt pages are published."""
    runs = []
    for mod in (tpages, jpages):
        c = mod.PrefixCache(num_pages=8, page_size=2)
        a = c.acquire([1, 2, 3, 4, 5], 3)
        c.release([1, 2, 3, 4, 5], a[0], 5)
        b = c.acquire([1, 2, 3, 4, 9], 7)
        assert b[1] == 4 and c.mapped_pages == 7
        c.release([1, 2, 3, 4, 9], b[0], 5)
        c.check_invariants()

        s = mod.PrefixCache(num_pages=8, page_size=2)
        a_pids, _ = s.acquire([1, 2, 3, 4, 5], 4)
        b_pids, _ = s.acquire([9, 8, 7, 6, 5], 3)
        s.release([9, 8, 7, 6, 5], b_pids, 5)
        doomed = s.acquire([40, 41, 42, 43, 44, 45, 46], 7)
        assert doomed is None and s.cached_pages == 2
        assert s.evicted_pages == 0
        s.release([1, 2, 3, 4, 5], a_pids, 5)
        late = s.acquire([40, 41, 42, 43, 44, 45, 46], 7)
        s.check_invariants()

        p = mod.PrefixCache(num_pages=16, page_size=4)
        pids, _ = p.acquire(list(range(10)), 4)
        p.release(list(range(10)), pids, prefilled_tokens=5)
        one = p.cached_pages
        pids2, matched2 = p.acquire(list(range(10)), 4)
        p.release(list(range(10)), pids2, prefilled_tokens=10)
        p.check_invariants()
        runs.append((a, b, late, c.stats(), s.stats(), one, matched2,
                     p.cached_pages, p.stats()))
    assert runs[0] == runs[1]
    assert runs[0][5] == 1 and runs[0][6] == 4 and runs[0][7] == 2


@pytest.mark.parametrize("args", [
    (9, 6, 4, 32, 0), (9, 6, 4, 32, 3), (9, 100, 4, 32, 3), (1, 1, 8, 32, 0),
    (31, 1, 16, 32, 0),
])
def test_page_demand_matches_jax(args):
    plen, n_new, ps, total, reserve = args
    assert tpages.page_demand(plen, n_new, ps, total_len=total,
                              reserve=reserve) == jpages.page_demand(
        plen, n_new, ps, total_len=total, reserve=reserve)


# ---- paged decode attention --------------------------------------------


def _paged_case(seed, S, H, H_kv, Dh, ps, lane_pages, quantized):
    """A shuffled pool and tables: lanes 0 and 1 share their first
    ``share`` pages (a forked prefix), every lane maps private pages up
    to its demand and the scratch page 0 past it; positions inside each
    lane's demand, one lane at the position ceiling (pos == L)."""
    rng = np.random.default_rng(seed)
    L = lane_pages * ps
    demand = rng.integers(1, lane_pages + 1, S)
    demand[-1] = lane_pages
    share = int(min(demand[0], demand[1]) - 1)
    P = int(demand.sum()) + 3
    free = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((S, lane_pages), np.int32)
    for s in range(S):
        for j in range(demand[s]):
            table[s, j] = table[0, j] if s == 1 and j < share else free.pop()
    pos = np.array([int(rng.integers(share * ps if s < 2 else 0, d * ps))
                    for s, d in enumerate(demand)], np.int32)
    pos[-1] = L
    q = rng.standard_normal((S, H, Dh), dtype=np.float32)
    k = rng.standard_normal((P, ps, H_kv, Dh), dtype=np.float32)
    v = rng.standard_normal((P, ps, H_kv, Dh), dtype=np.float32)
    ks = vs = None
    if quantized:
        k, ks = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(v)))
    return q, k, v, table, pos, ks, vs


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize(
    "S,H,H_kv,Dh,ps,lane_pages",
    [
        (4, 4, 4, 8, 4, 8),    # MHA, the engine's test shape
        (5, 8, 2, 16, 8, 4),   # GQA group 4
        (3, 4, 2, 8, 16, 2),   # a page wider than the kernel's tile rows
    ],
)
def test_paged_plain_matches_jax_and_fixed_lane(S, H, H_kv, Dh, ps,
                                                lane_pages, quantized):
    """The port's plain paged version ≡ JAX's paged reference and its
    Pallas kernel (interpret mode, block_k = page_size), and bitwise the
    port's fixed-lane plain version over the gathered lanes; the kernel's
    split emulated over the gathered lanes agrees; the CPU wrappers
    launch nothing."""
    case = _paged_case(S * 31 + Dh + ps, S, H, H_kv, Dh, ps, lane_pages,
                       quantized)
    q, k, v, table, pos, ks, vs = _t(*case)
    before = (dict(tdec.flash_decode_paged_attention.launches),
              tdec.flash_decode_paged_attention.plain_routed,
              dict(tdec.flash_decode_attention.launches))
    got = tdec.paged_decode_attention_reference(q, k, v, table, pos, ks, vs)
    jref = jdec.paged_decode_attention(*_j(*case), impl="reference")
    jfl = jdec.paged_decode_attention(*_j(*case), impl="flash",
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfl), atol=ATOL,
                               rtol=RTOL)
    gather = tdec.gather_paged_kv
    lanes = [gather(k, table), gather(v, table), pos,
             None if ks is None else gather(ks, table),
             None if vs is None else gather(vs, table)]
    assert torch.equal(got, tdec.decode_attention_reference(q, *lanes))
    chunk = 2 * ps
    split = tdec.decode_attention_split_reference(q, *lanes, chunk=chunk)
    np.testing.assert_allclose(split.numpy(), got.numpy(), atol=ATOL,
                               rtol=RTOL)
    for impl in ("auto", "flash", "reference"):
        assert torch.equal(got, tdec.paged_decode_attention(
            q, k, v, table, pos, ks, vs, impl=impl))
    assert torch.equal(got, tdec.flash_decode_paged_attention(
        q, k, v, table, pos, ks, vs))
    assert (dict(tdec.flash_decode_paged_attention.launches),
            tdec.flash_decode_paged_attention.plain_routed,
            dict(tdec.flash_decode_attention.launches)) == before


def test_gather_paged_kv_matches_jax_for_rows_and_scales():
    q, k, v, table, pos, ks, vs = _paged_case(5, 3, 4, 2, 16, 4, 4, True)
    for pool in (k, ks):
        got = tdec.gather_paged_kv(*_t(pool, table))
        want = np.asarray(jdec.gather_paged_kv(jnp.asarray(pool),
                                               jnp.asarray(table)))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kernel_predicate():
    """What the paged kernel takes: kernel_takes' head shapes and pool
    strides, a power-of-two page size and a contiguous int32 table; an
    unknown impl raises."""
    q, k, v, table, pos, ks, vs = _t(*_paged_case(3, 2, 4, 2, 16, 4, 4,
                                                  False))
    take = tdec._paged_tensors_take
    assert take(q, k, v, table)
    assert not take(q, k, v, table.long())
    assert not take(q, k, v, table.t().contiguous().t())
    k3, v3 = k[:, :3], v[:, :3]
    assert not take(q, k3, v3, table)  # page size 3, and strided rows
    q24 = torch.zeros(2, 4, 24)
    k24 = torch.zeros(9, 4, 2, 24, dtype=torch.int8)
    assert not take(q24, k24, k24, table)  # int8 at Dh 24
    assert take(q24, k24.float(), k24.float(), table)
    with pytest.raises(ValueError, match="unknown decode attention impl"):
        tdec.paged_decode_attention(q, k, v, table, pos, impl="pallas")


# ---- the paged cache: decode step and prefill chunk ----------------------


def _paged_caches(jspec, kv_dtype, table, pos, num_pages, seed=3):
    """The same random pool as a JAX and a port PagedSlotCache."""
    rng = np.random.default_rng(seed)
    h_kv = jspec.num_kv_heads or jspec.num_heads
    ps = TOTAL_LEN // table.shape[1]
    shape = (jspec.depth, num_pages, ps, h_kv, D // HEADS)
    kf = rng.standard_normal(shape, dtype=np.float32)
    vf = rng.standard_normal(shape, dtype=np.float32)
    pos = np.asarray(pos, np.int32)
    if kv_dtype == "int8":
        k, ks = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(kf)))
        v, vs = (np.asarray(a) for a in jdec.quantize_kv(jnp.asarray(vf)))
        arrays = (k, v, pos, table, ks, vs)
    else:
        arrays = (kf, vf, pos, table)
    jc = jgen.PagedSlotCache(*map(jnp.asarray, arrays))
    tc = tgen.PagedSlotCache(*(torch.from_numpy(a.copy()) for a in arrays))
    return jc, tc


def _assert_pool_close(tc, jc):
    """Pools equal past the scratch page (JAX drops out-of-lane writes,
    the port puts them in page 0)."""
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    if tc.quantized():
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            d = np.abs(a.numpy()[:, 1:].astype(np.int32)
                       - np.asarray(b, np.int32)[:, 1:])
            assert d.max() <= 1 and (d > 0).mean() < 1e-3  # one step
        for a, b in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(a.numpy()[:, 1:],
                                       np.asarray(b)[:, 1:], rtol=1e-5,
                                       atol=0)
    else:
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(a.numpy()[:, 1:],
                                       np.asarray(b)[:, 1:], atol=ATOL)


TABLE = np.array([[3, 5, 0, 0, 0, 0, 0, 0],      # two pages, then scratch
                  [3, 7, 8, 0, 0, 0, 0, 0],      # shares page 3 with lane 0
                  [0, 0, 0, 0, 0, 0, 0, 0],      # idle
                  [1, 2, 4, 6, 9, 10, 11, 12]],  # a full lane
                 np.int32)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_paged_decode_step_matches_jax(kv_heads, kv_dtype):
    """Lanes sharing a prefix page, an idle lane on the scratch page and a
    full lane parked at the position ceiling: logits of the mapped lanes,
    pool and pos. The idle lane's logits are garbage in both packages
    (the engine ignores them): it reads the scratch page, where the
    ceiling lane's out-of-lane write lands in the port and is dropped in
    JAX."""
    jspec, jparams, model = pair(kv_heads)
    pos = [6, 9, 0, TOTAL_LEN]
    jc, tc = _paged_caches(jspec, kv_dtype, TABLE, pos, 13)
    tokens = np.asarray([3, 30, 7, 11], np.int32)
    jl, jc2 = jgen.slot_decode_step(jspec, jparams, jc, jnp.asarray(tokens))
    tl = tgen.slot_decode_step(model, tc, torch.from_numpy(tokens))
    assert np.isfinite(tl.numpy()).all()
    mapped = [0, 1, 3]
    np.testing.assert_allclose(tl.numpy()[mapped], np.asarray(jl)[mapped],
                               atol=LOGITS_ATOL, rtol=0)
    assert tc.pos.tolist() == [7, 10, 1, TOTAL_LEN]
    _assert_pool_close(tc, jc2)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_prefill_chunk_after_a_prefix_hit_matches_jax(kv_dtype):
    """Lane 1 maps page 3, prefilled by lane 0 (a hit of 4 tokens), and
    ingests its tail as continuation chunks from position 4: it attends
    the matched page it never prefilled. Pool, pos, sampling state and
    the first token match JAX; page 3 keeps its bytes."""
    jspec, jparams, model = pair(2)
    S = 4
    jc, tc = _paged_caches(jspec, kv_dtype, TABLE, [0] * S, 13)
    shared = tc.k[:, 3].clone()
    prompt = np.random.default_rng(5).integers(0, VOCAB, 11)
    jstate = [jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.int32),
              jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.float32),
              jnp.ones(S, jnp.float32)]
    tstate = [torch.zeros(S, dtype=torch.int64) for _ in range(3)] + [
        torch.zeros(S), torch.ones(S)]
    for start, width, live, final in ((4, 4, 4, False), (8, 4, 3, True)):
        buf = np.zeros(width, np.int32)
        buf[:live] = prompt[start:start + live]
        jout = jgen.prefill_chunk(
            jspec, jparams, jc, *jstate, jnp.int32(1), jnp.asarray(buf),
            jnp.int32(start), jnp.int32(live), jnp.asarray(final),
            jnp.int32(9), jnp.float32(0.0), jnp.float32(1.0),
            lane_attend=True,
        )
        jc, jstate, jfirst = jout[0], list(jout[1:6]), jout[6]
        tfirst = tgen.prefill_chunk(
            model, tc, *tstate, 1, torch.from_numpy(buf).long(), start,
            live, final, 9, 0.0, 1.0, lane_attend=True,
        )
        _assert_pool_close(tc, jc)
        assert tc.pos.tolist() == [0, start + live, 0, 0]
        for t, j in zip(tstate, jstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        if final:
            assert int(tfirst) == int(jfirst) == int(tstate[0][1])
    assert torch.equal(tc.k[:, 3], shared)


def test_page_scatter_ids_route_out_of_lane_to_scratch():
    """In-lane positions map as JAX's _page_scatter_ids; positions at or
    past the table's end go to page 0 (JAX: num_pages, dropped)."""
    posns = np.array([[0, 5, 31, 32, 40], [3, 4, 8, 12, 33]], np.int64)
    pids, offs = tgen._page_scatter_ids(torch.from_numpy(TABLE[:2]),
                                        torch.from_numpy(posns), 4)
    jp, jo = jgen._page_scatter_ids(jnp.asarray(TABLE[:2]),
                                    jnp.asarray(posns, jnp.int32), 4, 13)
    jp = np.where(np.asarray(jp) == 13, 0, np.asarray(jp))
    np.testing.assert_array_equal(pids.numpy(), jp)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(jo))
    assert pids[0, 3] == pids[0, 4] == pids[1, 4] == 0


# ---- the paged engine ----------------------------------------------------


def _run(eng, batches, *, step_between=False, watch=None):
    """Submit each batch of (prompt, n_new) and run to idle → the
    requests' completions; ``watch`` is called after every step."""
    out = []
    for batch in batches:
        for prompt, n in batch:
            out.append(eng.submit(prompt, n).request.rid)
            if step_between:
                eng.step()
        while eng.pending:
            eng.step()
            if watch:
                watch(eng)
    return [eng.result(r) for r in out]


def _engines(kv_heads=0, **knobs):
    jspec, jparams, model = pair(kv_heads)
    return (JEngine(jspec, jparams, decode_attn="reference", **knobs),
            ServeEngine(model, **knobs), model)


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_bucket_and_page_boundaries_match_jax(kv_heads):
    """test_paged.py:51: prompt lengths straddling every bucket edge and
    page boundary (page_size 8, buckets {4, 8}), staggered admission."""
    jeng, teng, model = _engines(kv_heads, slots=2, prefill_len=16,
                                 prefill_chunk=8, min_bucket=4, page_size=8)
    assert teng.buckets == jeng.buckets == [4, 8]
    prompts = [[(7 * n + i) % VOCAB for i in range(n)]
               for n in (1, 3, 4, 7, 8, 9, 12, 15, 16)]
    batch = [[(p, 5) for p in prompts]]
    want = _run(jeng, batch, step_between=True)
    got = _run(teng, batch, step_between=True)
    for p, c, w in zip(prompts, got, want):
        assert c.status == COMPLETE and c.tokens == w.tokens
        _assert_gaps(model, p, c.tokens)
    assert teng.page_stats() == jeng.page_stats()
    teng._prefix.check_invariants()


def test_forked_prefix_pair_matches_jax():
    """test_paged.py:97: a retired prompt's pages serve two later requests
    sharing its 12-token prefix; hits 0/12/12, three shared pages while
    both forks decode, hits/misses 2/1, streams identical to JAX's."""
    jeng, teng, model = _engines(slots=2, prefill_len=16, page_size=4)
    pre = [(3 * i + 2) % VOCAB for i in range(12)]
    batches = [[(pre + [1, 2], 6)], [(pre + [9, 9], 6), (pre + [4], 6)]]
    seen = {}

    def watch(eng):
        seen[eng] = max(seen.get(eng, 0), eng.page_stats()["pages_shared"])

    want = _run(jeng, batches, watch=watch)
    got = _run(teng, batches, watch=watch)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.prefix_hit_tokens for c in got] == [0, 12, 12]
    assert [c.prefix_hit_tokens for c in want] == [0, 12, 12]
    assert seen[teng] >= 3 and seen[teng] == seen[jeng]
    st = teng.page_stats()
    assert st["prefix_hits"] == 2 and st["prefix_misses"] == 1
    assert st == jeng.page_stats()
    for (prompt, _), c in zip(batches[0] + batches[1], got):
        assert c.status == COMPLETE
        _assert_gaps(model, prompt, c.tokens)
    teng._prefix.check_invariants()


def test_int8_paged_matches_int8_fixed_lane_and_jax():
    """test_paged.py:131: an int8 pool quantizes on write per page; its
    streams equal the fixed-lane int8 engine's and the JAX paged int8
    engine's, through a prefix hit."""
    pre = [(5 * i + 1) % VOCAB for i in range(9)]
    batches = [[(pre + [2], 5)], [(pre + [3], 5)], [([4, 4], 5)]]
    jeng, paged, _ = _engines(slots=2, prefill_len=16, kv_dtype="int8",
                              page_size=8)
    _, fixed, _ = _engines(slots=2, prefill_len=16, kv_dtype="int8")
    got = [c.tokens for c in _run(paged, batches)]
    assert got == [c.tokens for c in _run(fixed, batches)]
    assert got == [c.tokens for c in _run(jeng, batches)]
    assert paged.page_stats()["prefix_hits"] == 1


def test_seeded_paged_matches_seeded_fixed_lane():
    """Seeded sampling has no JAX twin (another generator), but the paged
    cache must not change a draw: the same requests on the fixed-lane
    engine give the same streams."""
    _, _, model = pair(0)
    cases = [([3, 1, 4, 1], 6, dict(temperature=0.8, seed=7)),
             ([2, 7], 5, dict(temperature=1.3, top_p=0.9, seed=3)),
             ([5, 3, 5, 8, 9], 4, dict(temperature=0.6, top_p=0.7, seed=-3)),
             ([9, 9], 5, {})]
    streams = []
    for knobs in ({}, {"page_size": 4}):
        eng = ServeEngine(model, slots=3, prefill_len=8, min_bucket=4,
                          **knobs)
        rids = [eng.submit(p, n, **kw).request.rid for p, n, kw in cases]
        eng.run()
        streams.append([eng.result(r).tokens for r in rids])
    assert streams[0] == streams[1]


def test_lru_eviction_keeps_correctness_like_jax():
    """test_paged.py:209: a pool of one lane plus one spare page evicts
    LRU prefixes between four distinct prompts; streams and pool stats
    equal JAX's."""
    jeng, teng, model = _engines(slots=1, prefill_len=16, page_size=4,
                                 kv_pages=10)
    prompts = [[(j * 7 + i) % VOCAB for i in range(9)] for j in range(4)]
    batches = [[(p, 4)] for p in prompts]
    got, want = _run(teng, batches), _run(jeng, batches)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    for p, c in zip(prompts, got):
        _assert_gaps(model, p, c.tokens)
    assert teng.page_stats()["evicted_pages"] > 0
    assert teng.page_stats() == jeng.page_stats()
    teng._prefix.check_invariants()


def test_page_starved_admission_requeues_fifo_like_jax():
    """test_paged.py:316: a pool of exactly one full lane delays the
    second request (requeued at the front) instead of failing it; both
    complete as JAX's do, the head first."""
    jeng, teng, _ = _engines(slots=2, prefill_len=16, page_size=4,
                             kv_pages=9)
    p1 = [(i + 1) % VOCAB for i in range(12)]
    p2 = [(i + 5) % VOCAB for i in range(12)]
    batch = [[(p1, 8), (p2, 8)]]
    got, want = _run(teng, batch), _run(jeng, batch)
    assert all(c.status == COMPLETE for c in got)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert teng.page_starved_binds > 0
    assert teng.page_starved_binds == jeng.page_starved_binds
    assert got[0].finished <= got[1].finished
    teng._prefix.check_invariants()


def test_rejection_matrix_matches_jax_messages():
    """test_paged.py:347: the same ValueError messages as the JAX
    engine."""
    cases = [dict(page_size=3), dict(page_size=2, kv_pages=3),
             dict(kv_pages=64), dict(page_size=64)]
    for kw in cases:
        jspec, jparams, model = pair(0)
        with pytest.raises(ValueError) as ours:
            ServeEngine(model, slots=2, prefill_len=8, **kw)
        with pytest.raises(ValueError) as theirs:
            JEngine(jspec, jparams, slots=2, prefill_len=8, **kw)
        assert str(ours.value) == str(theirs.value)
    for kw, match in ((["--page_size", "3"], "power of two"),
                      (["--kv_pages", "9"], "--kv_pages needs --page_size")):
        with pytest.raises(ValueError, match=match):
            serve_main(["--init_demo", "--device", "cpu", *kw])


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_shared_prefix_pages_keep_their_bytes(kv_dtype):
    """Two hits on a published 8-token prefix ingest 12-token tails in
    chunks of 4 while the other lane decodes between them (idle-shape
    decode steps write at every lane's pos): the prefix pages' K/V (and
    int8 scales) keep every byte, and the streams equal the fixed-lane
    engine's."""
    _, _, model = pair(2)
    pre = [(5 * i + 3) % VOCAB for i in range(8)]
    tails = [[(i * 11 + j) % VOCAB for i in range(12)] for j in (1, 2)]
    knobs = dict(slots=2, prefill_len=24, prefill_chunk=4, min_bucket=4,
                 kv_dtype=kv_dtype)
    eng = ServeEngine(model, page_size=4, **knobs)
    first = _run(eng, [[(pre + [1], 3)]])
    cache = eng._cache
    pids = eng._prefix.match(pre, 2)
    assert len(pids) == 2
    parts = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                  if kv_dtype == "int8" else [])
    before = [t[:, pids].clone() for t in parts]
    batch = [[(pre + tails[0], 10), (pre + tails[1], 3)]]
    got = _run(eng, batch, step_between=True)
    assert [c.prefix_hit_tokens for c in got] == [8, 8]
    assert all(torch.equal(t[:, pids], b) for t, b in zip(parts, before))
    fixed = ServeEngine(model, **knobs)
    want = _run(fixed, [[(pre + [1], 3)]]) + _run(fixed, batch,
                                                  step_between=True)
    assert [c.tokens for c in first + got] == [c.tokens for c in want]


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=30) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_reply_and_stats_carry_the_paged_block():
    """/generate carries prefix_hit_tokens on a paged engine (0 for the
    miss, 8 for the hit), and /stats has the paged block."""
    _, _, model = pair(0)
    eng = ServeEngine(model, slots=2, prefill_len=16, page_size=4)
    pre = [(2 * i + 1) % VOCAB for i in range(8)]
    with LMServer(eng) as srv:
        a = _post(srv.url, {"prompt_tokens": pre + [3], "max_new_tokens": 4})
        b = _post(srv.url, {"prompt_tokens": pre + [5], "max_new_tokens": 4})
        stats = _get(srv.url, "/stats")
    assert a["status"] == b["status"] == COMPLETE
    assert (a["prefix_hit_tokens"], b["prefix_hit_tokens"]) == (0, 8)
    paged = stats["paged"]
    assert paged["prefix_hits"] == 1 and paged["prefix_misses"] == 1
    assert paged["page_size"] == 4 and paged["lane_pages"] == 8
    assert paged["num_pages"] == 2 * 8 + 1
    assert set(paged) >= {"pages_free", "pages_cached", "pages_shared",
                          "prefix_hit_rate", "page_starved_binds",
                          "effective_slots_multiplier"}
    assert "paged" not in ServeEngine(model, slots=2).stats()
