"""The serving engine's compile contract in the port, on the CPU.

``ddp_tpu_torch/serve/programs.py`` holds the engine's step programs:
one decode program, a first-chunk and a continuation-chunk program per
bucket width, and with speculation the draft's chunk programs, one
draft-decode and one verify program. On the card each is a captured
CUDA graph; here the same functions run eagerly over the same static
buffers (d 32, depth 2, total_len 32, buckets [2, 4, 8]). Pinned:

- ``warmup()`` returns the JAX engine's ``warmup()`` dict key for key,
  and ``compile_budget()`` equals JAX's: fixed-lane fp32 and int8,
  paged, speculative (γ 2 with a draft); ``warmup()`` on a busy engine
  raises; after warmup the mix of ``tests/test_serve.py``'s
  ``test_no_recompilation_after_warmup`` (every prompt length, mixed
  sampling, a queue timeout, a running eviction, slot churn), and
  paged prefix traffic, leave ``compile_counts()`` unchanged.
- Greedy streams through the programs equal the JAX engine's (fp32,
  int8, paged, speculative); seeded streams equal the eager port's
  step functions driven directly with the old per-batch sampling flags
  (the fused program always samples and filters, and must give the
  same tokens).
- ``prefill_chunk_device`` (0-dim device scalars) equals the host-int
  ``prefill_chunk`` and JAX's ``prefill_chunk``: every bucket, first and
  continuation chunks, final and not, fixed-lane and paged, fp32 and
  int8 — K/V within 1e-5 (int8: one rounding step, the rule of
  test_torch_generate), the first token's logits within 1e-5, the token,
  ``pos`` and the sampling state exact.
- ``install_params`` after warmup serves the new weights (a fresh
  engine's streams), and adds no program.
- ``stats()["compile_counts"]`` is ``compile_counts()``; ``/metricsz``
  renders ``ddp_tpu_serve_compiled_programs`` as JAX's ``render_serve``
  does and lints; the serve CLI warms up before it serves (its startup
  line carries the counts) unless ``--no_warmup``.
- ``StepProgram``'s capture bookkeeping, with torch.cuda's graph calls
  replaced by fakes: the capture's side-stream call is the first run
  and the only one counted, a replay adds the launches recorded at
  capture, and a failed capture raises with the program's name and
  leaves the counters as they were.
"""

import contextlib
import copy
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import generate as jgen
from ddp_tpu.obs import promtext as jprom
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu_torch.models import generate as tgen
from ddp_tpu_torch.obs import promtext as tprom
from ddp_tpu_torch.ops import decode as tdec
from ddp_tpu_torch.serve import programs
from ddp_tpu_torch.serve.engine import (
    COMPLETE,
    TIMEOUT_EVICTED,
    TIMEOUT_QUEUE,
    ServeEngine,
)
from ddp_tpu_torch.serve.scheduler import Scheduler
from test_torch_generate import _assert_cache_close, _random_caches
from test_torch_metricsz import _get, _post, _serve_main
from test_torch_paged import TABLE, _assert_pool_close, _paged_caches
from test_torch_serve import _assert_gaps, _serve_both
from test_torch_spec import DRAFT, SPEC, _serve, draft, pair, target

# buckets [2, 4, 8]: chunk 8, min_bucket 2, prefill_len 16 of total_len 32
KNOBS = dict(slots=2, prefill_len=16, prefill_chunk=8, min_bucket=2)
GAMMA = 2
KINDS = {"fixed-fp32": {}, "fixed-int8": {"kv_dtype": "int8"},
         "paged": {"page_size": 4}, "spec": {"spec_tokens": GAMMA}}
ATOL = 1e-5  # K/V rows and first-token logits, fp32 at d 32


def _port_engine(kind, **kw):
    _, _, model = target()
    knobs = {**KNOBS, **KINDS[kind], **kw}
    if kind == "spec":
        knobs["draft_model"] = draft()[2]
    return ServeEngine(model, **knobs)


@functools.lru_cache(maxsize=None)
def _jax_engine(kind):
    """One JAX engine of ``kind`` for the file: the speculative stream
    test serves on it first, so that its warmup() later compiles only
    what that traffic did not (each test stays under 9 s)."""
    jspec, jparams, _ = target()
    knobs = {**KNOBS, **KINDS[kind]}
    if kind == "spec":
        knobs.update(draft_spec=DRAFT, draft_params=draft()[1])
    return JEngine(jspec, jparams, decode_attn="reference", **knobs)


def _expected(engine):
    n = len(engine.buckets)
    want = {"prefill_first": n, "prefill_chunk": n, "decode": 1}
    if engine.spec_tokens:
        want.update(draft_prefill_first=n, draft_prefill_chunk=n,
                    draft_decode=1, spec_verify=1)
    return want


# ---- streams through the programs ------------------------------------------

PROMPTS = [[(7 * n + i) % 64 for i in range(n)] for n in (1, 2, 3, 5, 8, 9, 16)]


@pytest.mark.parametrize("kind", ["fp32", "int8", "paged"])
def test_greedy_streams_through_programs_match_jax(kind):
    knobs = dict(KNOBS, **({"page_size": 4} if kind == "paged" else {}))
    kv_dtype = "int8" if kind == "int8" else "fp32"
    model, (jax_streams, port_streams) = _serve_both(
        0, kv_dtype, PROMPTS, 5, total_len=32, **knobs)
    assert port_streams == jax_streams
    for p, s in zip(PROMPTS, port_streams):
        _assert_gaps(model, p, s)


def test_greedy_spec_streams_through_programs_match_jax():
    """γ 2 through the draft_decode and spec_verify programs, the port
    engine warmed up first; the programs prepared stay the warm set."""
    cases = [([(5 * n + i) % SPEC.vocab_size for i in range(n)], 3 + n % 4, {})
             for n in (3, 9, 16)]
    eng = _port_engine("spec")
    warm = eng.warmup()
    jeng = _jax_engine("spec")
    got = _serve(eng, cases, step_between=True)
    assert got == _serve(jeng, cases, step_between=True)
    assert eng.compile_counts() == warm
    _, _, model = target()
    for (prompt, _, _), toks in zip(cases, got):
        _assert_gaps(model, prompt, toks)


def _eager_stream(model, engine, prompt, n, *, temperature=0.0, top_p=1.0,
                  seed=0):
    """One request alone on lane 0 of an engine-shaped cache, through the
    port's step functions with the per-batch flags the engine passed
    before its programs (sampling only with a drawing lane, the vocab
    sort only with a nucleus lane), on the engine's chunk plan."""
    spec = model.spec
    sched = Scheduler(max_queue=1, prefill_len=engine.prefill_len,
                      total_len=spec.total_len, chunk=engine.prefill_chunk,
                      min_bucket=engine.min_bucket,
                      token_budget=engine.step_token_budget)
    S = engine.num_slots
    cache = tgen.init_slot_cache(spec, S, device="cpu")
    toks, seeds, steps = (torch.zeros(S, dtype=torch.int64) for _ in range(3))
    temps, top_ps = torch.zeros(S), torch.ones(S)
    start, out = 0, []
    while start < len(prompt):
        [(_, width)] = sched.plan_chunks([(0, start, len(prompt) - start)], 0)
        live = min(width, len(prompt) - start)
        buf = torch.zeros(width, dtype=torch.int64)
        buf[:live] = torch.tensor(prompt[start:start + live])
        final = start + live == len(prompt)
        first = tgen.prefill_chunk(
            model, cache, toks, seeds, steps, temps, top_ps, 0, buf, start,
            live, final, seed, temperature, top_p, lane_attend=start != 0)
        start += live
    out.append(int(first))
    drawing = temperature > 0
    for _ in range(n - 1):
        toks = tgen.slot_decode_sample_step(
            model, cache, toks, seeds, steps, temps, top_ps,
            sampling=drawing, nucleus=drawing and top_p < 1)
        out.append(int(toks[0]))
    return out


def test_seeded_streams_equal_the_eager_port():
    _, _, model = target()
    eng = ServeEngine(model, **KNOBS)
    eng.warmup()
    cases = [([3, 1, 4, 1, 5], 9, dict(temperature=0.9, top_p=0.8, seed=5)),
             ([2, 7] * 5, 7, dict(temperature=1.3, seed=-2)),
             ([9] * 12, 6, {})]
    for prompt, n, kw in cases:
        got = _serve(eng, [(prompt, n, kw)])[0]
        assert got == _eager_stream(model, eng, prompt, n, **kw)


# ---- warmup, compile_counts, compile_budget --------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_warmup_counts_and_budget_match_jax(kind):
    eng = _port_engine(kind)
    jeng = _jax_engine(kind)
    jwarm = jeng.warmup()
    assert eng.buckets == jeng.buckets == [2, 4, 8]
    assert eng.compile_counts() == dict.fromkeys(jwarm, 0)  # nothing yet
    warm = eng.warmup()
    assert warm == jwarm and list(warm) == list(jwarm)  # keys in order
    assert warm == _expected(eng)
    assert eng.compile_budget() == jeng.compile_budget() == sum(warm.values())
    assert eng.warmup() == warm  # a second warmup prepares nothing new
    assert not eng.cuda_graphs and eng.graph_pool_bytes() == 0


def test_warmup_on_a_busy_engine_raises():
    eng = _port_engine("fixed-fp32")
    eng.submit([1, 2, 3], 4)
    eng.step()
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.warmup()
    eng.run()
    assert eng.warmup() == _expected(eng)  # idle again


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def test_no_program_added_after_warmup_by_any_request_mix():
    """tests/test_serve.py:233's mix on the port engine."""
    _, _, model = target()
    clock = FakeClock()
    eng = ServeEngine(model, slots=3, prefill_len=8, prefill_chunk=8,
                      min_bucket=2, clock=clock)
    assert eng.buckets == [2, 4, 8]
    warm = eng.warmup()
    assert warm == {"prefill_first": 3, "prefill_chunk": 3, "decode": 1}
    for plen in range(1, 9):
        temp = 0.5 * (plen % 3)
        adm = eng.submit(
            list(range(1, plen + 1)), 3 + plen % 4, temperature=temp,
            top_p=1.0 - 0.1 * (plen % 2) if temp > 0 else 1.0, seed=plen)
        assert adm.accepted
        eng.step()
    eng.submit([4, 4], 6, timeout=1e-9)  # expires in the queue
    victim = eng.submit([6, 6, 6], 20, timeout=5.0).request
    eng.step()
    clock.t = 10.0  # the running deadline passes mid-decode
    eng.run()
    assert eng.result(victim.rid).status in (TIMEOUT_EVICTED, TIMEOUT_QUEUE)
    assert eng.compile_counts() == warm


def test_no_program_added_after_warmup_by_paged_prefix_traffic():
    """tests/test_paged.py:269: hits, misses, retires compile nothing."""
    eng = _port_engine("paged")
    counts = eng.warmup()
    assert sum(counts.values()) <= eng.compile_budget()
    pre = [(i * 3 + 1) % SPEC.vocab_size for i in range(9)]
    for tail in ([1], [2], [3, 4]):
        eng.submit(pre + tail, 4)
        eng.step()
    eng.run()
    assert eng.page_stats()["prefix_hits"] >= 1
    assert eng.compile_counts() == counts


# ---- the device-scalar prefill chunk ----------------------------------------

# (start, live, final) per bucket width: a first chunk, final and not,
# then continuation chunks, final and not; lane 3.
CHUNKS = [(0, 0, False), (0, -1, True), (4, 0, False), (12, -1, True)]


def _scalars(*values):
    ints = [torch.tensor(int(v), dtype=torch.int64) for v in values[:5]]
    return ints + [torch.tensor(float(v)) for v in values[5:]]


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("layout", ["fixed", "paged"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_device_scalar_prefill_chunk_matches_host_int_and_jax(
        layout, kv_dtype, width, monkeypatch):
    jspec, jparams, model = target(kv_heads=2)
    S, slot = 4, 3  # lane 3 maps all 8 pages of TABLE
    if layout == "paged":
        jc, tc = _paged_caches(jspec, kv_dtype, TABLE, [0] * S, 13)
        assert_close = _assert_pool_close
    else:
        jc, tc = _random_caches(jspec, kv_dtype, S, [0] * S)
        assert_close = _assert_cache_close
    tc2 = copy.deepcopy(tc)
    jstate = [jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.int32),
              jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.float32),
              jnp.ones(S, jnp.float32)]
    tstate = [torch.zeros(S, dtype=torch.int64) for _ in range(3)] + [
        torch.zeros(S), torch.ones(S)]
    tstate2 = [t.clone() for t in tstate]
    seen = {"jax": [], "port": []}
    real_j, real_t = jgen.sample_token, tgen.sample_slot_tokens
    monkeypatch.setattr(jgen, "sample_token", lambda logits, *a, **kw: (
        seen["jax"].append(np.asarray(logits)), real_j(logits, *a, **kw))[1])
    monkeypatch.setattr(tgen, "sample_slot_tokens", lambda logits, *a, **kw: (
        seen["port"].append(logits.clone()), real_t(logits, *a, **kw))[1])
    prompt = np.random.default_rng(5).integers(0, SPEC.vocab_size, 32)
    for start, live, final in CHUNKS:
        live = width + live if live <= 0 else live
        buf = np.zeros(width, np.int32)
        buf[:live] = prompt[start:start + live]
        lane_attend = start != 0
        with jax.disable_jit():  # the first-token branch runs eagerly
            jout = jgen.prefill_chunk(
                jspec, jparams, jc, *jstate, jnp.int32(slot),
                jnp.asarray(buf), jnp.int32(start), jnp.int32(live),
                jnp.asarray(final), jnp.int32(9), jnp.float32(0.0),
                jnp.float32(1.0), lane_attend=lane_attend)
        jc, jstate, jfirst = jout[0], list(jout[1:6]), jout[6]
        chunk = torch.from_numpy(buf).long()
        tfirst = tgen.prefill_chunk(
            model, tc, *tstate, slot, chunk, start, live, final, 9, 0.0,
            1.0, lane_attend=lane_attend)
        dfirst = tgen.prefill_chunk_device(
            model, tc2, *tstate2, chunk=chunk,
            **dict(zip(("slot", "start", "length", "final", "seed",
                        "temperature", "top_p"),
                       _scalars(slot, start, live, final, 9, 0.0, 1.0))),
            lane_attend=lane_attend)
        label = (width, start, live, final)
        assert_close(tc, jc)
        for a, b in ((tc.k, tc2.k), (tc.v, tc2.v), (tc.pos, tc2.pos)):
            assert torch.equal(a, b), label
        assert tc.pos.tolist()[slot] == start + live
        for t, t2, j in zip(tstate, tstate2, jstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert torch.equal(t, t2)
        # The port draws on every chunk, the host-int wrapper's and
        # the device call's from the same logits.
        lt, ld = seen["port"][-2:]
        assert torch.equal(lt, ld), label
        if final:
            np.testing.assert_allclose(ld[0].numpy(), seen["jax"][-1],
                                       atol=ATOL, rtol=0)
            assert int(tfirst) == int(dfirst) == int(jfirst) == int(
                tstate[0][slot])
        else:
            assert tfirst is None
    assert len(seen["jax"]) == 2  # JAX drew on the final chunks only


# ---- weights, stats, /metricsz, the CLI -------------------------------------


def test_install_params_after_warmup_serves_the_new_weights():
    _, _, model = target()
    _, other = pair(SPEC, 1)
    eng = ServeEngine(copy.deepcopy(model), **KNOBS)
    warm = eng.warmup()
    cases = [([1, 2, 3], 5, {}), ([4] * 9, 4, dict(temperature=0.7, seed=3))]
    before = _serve(eng, cases)
    eng.install_params(other.state_dict(), model_version="b")
    after = _serve(eng, cases)
    fresh = ServeEngine(other, **KNOBS)
    fresh.warmup()
    assert after == _serve(fresh, cases) and after != before
    assert eng.compile_counts() == warm


def test_stats_compile_counts_and_metricsz_render_like_jax():
    eng = _port_engine("spec")
    eng.warmup()
    _serve(eng, [([1, 2, 3], 4, {})])
    stats = eng.stats()
    assert stats["compile_counts"] == eng.compile_counts() == _expected(eng)
    ours = tprom.render_serve(stats, up=True)
    theirs = jprom.render_serve(stats, up=True)
    tprom.validate_promtext(ours)

    def gauges(text):
        return [line for line in text.splitlines()
                if "ddp_tpu_serve_compiled_programs" in line
                and not line.startswith("# HELP")]

    assert gauges(ours) == gauges(theirs)
    assert len(gauges(ours)) == 1 + len(_expected(eng))  # TYPE + samples
    assert 'ddp_tpu_serve_compiled_programs{program="spec_verify"} 1' in ours
    assert "CUDA graphs" in ours


def test_cli_warms_up_before_it_serves():
    def traffic(url):
        return (_post(url, {"prompt_tokens": [1, 2, 3], "max_new_tokens": 3}),
                _get(url, "/stats")[2])

    lines, (reply, stats) = _serve_main(["--init_demo"], traffic)
    first = lines[0]
    n = len(first["buckets"])
    want = {"prefill_first": n, "prefill_chunk": n, "decode": 1}
    assert first["compile_counts"] == want == stats["compile_counts"]
    assert first["cuda_graphs"] is False and first["graph_pool_bytes"] == 0
    assert reply["status"] == COMPLETE


# ---- StepProgram's capture bookkeeping, with fake CUDA graph calls ------------


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_cuda(monkeypatch, *, fail=False):
    """torch.cuda's stream and graph calls as no-ops; ``graph`` runs the
    captured body (as a capture runs the Python) and raises after it
    when ``fail``."""
    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        assert not gc.isenabled()  # no dead engine's graph freed inside
        yield
        if fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    for name, value in (("graph", graph), ("CUDAGraph", _FakeGraph),
                        ("Stream", Stream),
                        ("device", lambda d: contextlib.nullcontext()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda d=None: Stream())):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(tdec.flash_decode_attention, "launches",
                        dict.fromkeys(tdec.flash_decode_attention.launches, 0))
    monkeypatch.setattr(tdec.flash_decode_paged_attention, "launches",
                        dict.fromkeys(tdec.flash_decode_paged_attention.launches,
                                      0))


def test_step_program_counts_follow_replays(monkeypatch):
    _fake_cuda(monkeypatch)
    calls = []

    def fn():
        calls.append(1)
        tdec.flash_decode_attention.launches["flash_decode_fp32"] += 2

    prog = programs.StepProgram("decode", fn, device=torch.device("cpu"),
                                graphs=True)
    prog.run()  # first use: the side-stream call (this run), the capture
    assert len(calls) == 2 and prog.prepared
    assert programs.launch_counts()["flash_decode_fp32"] == 2
    assert prog.per_replay == {"flash_decode_fp32": 2}
    prog.run()
    prog.run()
    assert len(calls) == 2 and prog.replays == prog.graph.replays == 2
    assert programs.launch_counts()["flash_decode_fp32"] == 6
    assert gc.isenabled()


def test_a_failed_capture_raises_with_the_program_name(monkeypatch):
    _fake_cuda(monkeypatch, fail=True)

    def fn():
        tdec.flash_decode_paged_attention.launches[
            "flash_decode_paged_int8"] += 1

    prog = programs.StepProgram("spec_verify", fn,
                                device=torch.device("cpu"), graphs=True)
    with pytest.raises(RuntimeError, match="'spec_verify' failed"):
        prog.prepare()
    assert not prog.prepared and prog.graph is None and gc.isenabled()
    # The side-stream call ran (counted); the failed capture counts nothing.
    assert programs.launch_counts()["flash_decode_paged_int8"] == 1
