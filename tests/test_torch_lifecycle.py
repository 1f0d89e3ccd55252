"""ddp_tpu_torch's serving lifecycle ≡ the JAX package's, on the CPU
(after ``tests/test_lifecycle.py``).

- The rejection reasons and the version label are the JAX package's;
  ``verify_reload_target`` names each of the three reasons and passes a
  sound checkpoint without reading a tensor.
- Hot-swap: a port engine serving JAX weights A (converted) reloads a
  port checkpoint of JAX weights B over ``POST /reload`` with requests
  in flight; every request completes, and the streams after the swap
  equal the JAX engine's greedy streams at B. A same-version reinstall
  keeps the prefix index; a new version flushes it. Every status of
  ``/reload``, with the rollback of a failing install. The stale-prefix
  control (a new version installed without the flush) must fail the
  check that the real path passes, on the first logits' bits and on
  the streams.
- Named models route to their own engine and counters; ``drain``
  answers 503 with ``Retry-After`` while running requests finish, and
  SIGTERM drains a ``python -m ddp_tpu_torch.serve`` process, which
  exits 0.
- Streaming restore: ``split_param_groups`` orders as JAX's, and the
  streamed state serves the streams of the monolithic restore.

Sizes: vocab 64, d_model 32, depth 2, 4 heads, T 32, 2-4 slots.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import ddp_tpu_torch.models.generate as gen
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.serve import lifecycle as jlc
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu_torch.interop.jax_params import lm_params_from_jax
from ddp_tpu_torch.models.lm import CausalLM
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.serve import engine as engine_mod
from ddp_tpu_torch.serve import lifecycle as lc
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.serve.server import LMServer
from ddp_tpu_torch.train.checkpoint import (
    STATE_FILE,
    CheckpointManager,
    save_lm_spec,
)
from ddp_tpu_torch.train.optim import make_optimizer
from test_torch_generate import numpy_lm_tree

REPO = Path(__file__).resolve().parent.parent
VOCAB, T, D, DEPTH, HEADS = 64, 32, 32, 2, 4
JSPEC = JSpec(VOCAB, T, D, DEPTH, HEADS)
PAGE = 4
# Prefix traffic: one 8-token prefix (two pages), a 3-token tail each.
PREFIX = [(5 * i + 3) % VOCAB for i in range(8)]
PROMPTS = [PREFIX + [(7 * j + i) % VOCAB for i in range(3)]
           for j in range(5)]
NEW, LONG_NEW = 6, 12
DRAIN_NEW = 40  # the request in flight at SIGTERM


def _tree(seed):
    return numpy_lm_tree(JSPEC, seed)


def _model(seed):
    spec, state = lm_params_from_jax(_tree(seed), num_heads=HEADS)
    return CausalLM.from_state(spec, state, "cpu")


def save_port_ckpt(directory, seed, *, epoch=0, jspec=JSPEC):
    """A port checkpoint of the numpy JAX tree at ``seed``: the trainer's
    layout (state.pt, manifest) and the sidecar."""
    spec, state = lm_params_from_jax(numpy_lm_tree(jspec, seed),
                                     num_heads=jspec.num_heads)
    model = CausalLM.from_state(spec, state, "cpu", trainable=True)
    opt = make_optimizer(model.parameters(), "sgd")
    mgr = CheckpointManager(str(directory))
    mgr.save(epoch, TrainState(0, model, opt))
    mgr.wait()  # the save is asynchronous: durable once wait() returns
    save_lm_spec(str(directory), spec)
    return str(directory)


@pytest.fixture(scope="module")
def ckpt_a(tmp_path_factory):
    return save_port_ckpt(tmp_path_factory.mktemp("ckpt_a"), 0)


@pytest.fixture(scope="module")
def ckpt_b(tmp_path_factory):
    return save_port_ckpt(tmp_path_factory.mktemp("ckpt_b"), 1)


def _engine(seed, version=None, **kw):
    knobs = dict(slots=2, prefill_len=16, max_queue=16)
    knobs.update(kw)
    return ServeEngine(_model(seed), model_version=version, **knobs)


def _run(engine, prompts, *, together=False) -> list:
    """Greedy streams; one request at a time unless ``together``."""
    if together:
        rids = [engine.submit(p, NEW).request.rid for p in prompts]
        engine.run()
    else:
        rids = []
        for p in prompts:
            rids.append(engine.submit(p, NEW).request.rid)
            engine.run()
    done = [engine.pop_result(r) for r in rids]
    assert all(c.status == COMPLETE for c in done)
    return done


@functools.lru_cache(maxsize=None)
def _jax_long_streams(seed) -> tuple:
    """The JAX engine's greedy streams of LONG_NEW tokens on PROMPTS at
    the numpy tree of ``seed`` (one compile per seed for the module)."""
    jeng = JEngine(JSPEC, jax.tree.map(jnp.asarray, _tree(seed)),
                   decode_attn="reference", slots=2, prefill_len=16)
    out = []
    for p in PROMPTS:
        rid = jeng.submit(p, LONG_NEW).request.rid
        jeng.run()
        out.append(tuple(jeng.result(rid).tokens))
    return tuple(out)


def _jax_streams(seed, n_prompts=len(PROMPTS), new=NEW) -> list:
    """A greedy stream of ``new`` tokens is the first ``new`` of a longer
    one."""
    return [list(t[:new]) for t in _jax_long_streams(seed)[:n_prompts]]


def test_reasons_and_version_label_equal_jax(tmp_path):
    assert lc.REJECTION_REASONS == jlc.REJECTION_REASONS
    for path in (str(tmp_path), str(tmp_path) + "/", "rel/dir", "ck"):
        for epoch in (0, 7):
            assert lc.model_version_token(path, epoch) == \
                jlc.model_version_token(path, epoch)


@pytest.mark.parametrize("case", ["success", "manifest_missing",
                                  "crc_mismatch", "spec_skew"])
def test_verify_reload_target(tmp_path, ckpt_a, case):
    spec = _model(0).spec
    if case == "success":
        target = lc.verify_reload_target(ckpt_a, current_spec=spec)
        assert target.version == lc.model_version_token(ckpt_a, 0)
        assert target.spec == spec and target.epoch == 0
        return
    if case == "manifest_missing":
        for d in (tmp_path / "empty", save_port_ckpt(tmp_path / "bare", 1)):
            Path(d, "epoch_0.manifest.json").unlink(missing_ok=True)
            with pytest.raises(lc.ReloadRejected) as e:
                lc.verify_reload_target(str(d), current_spec=spec)
            assert e.value.reason == lc.REASON_MANIFEST_MISSING
        return
    if case == "crc_mismatch":
        d = save_port_ckpt(tmp_path / "torn", 1)
        path = Path(d, "epoch_0", STATE_FILE)
        data = bytearray(path.read_bytes())
        data[-100] ^= 0xFF
        path.write_bytes(bytes(data))
        with pytest.raises(lc.ReloadRejected) as e:
            lc.verify_reload_target(d, current_spec=spec)
        assert e.value.reason == lc.REASON_CRC_MISMATCH
        assert "checksum" in e.value.detail
        return
    d = save_port_ckpt(tmp_path / "wide", 1, jspec=JSPEC._replace(d_model=48))
    with pytest.raises(lc.ReloadRejected) as e:
        lc.verify_reload_target(d, current_spec=spec)
    assert e.value.reason == lc.REASON_SPEC_SKEW
    assert "d_model: 48" in e.value.detail


def test_hot_swap_in_flight_then_streams_equal_jax_at_b(monkeypatch, ckpt_a,
                                                       ckpt_b):
    """A burst straddling ``POST /reload``: the load returns while both
    lanes are bound and at least 3 requests queue (so at most 2 can bind
    before the pause), every request completes, those bound before the
    barrier under A and the queued ones under B, each stream the JAX
    engine's at its version's weights; afterwards the engine serves B
    with the new version label.

    The burst forms by construction: the engine loop starts only once
    all six requests sit in the scheduler, and after its first step (two
    lanes bound, four queued) it holds until the load has seen them. A
    free-running loop could retire the first two lanes, or take the
    lock step after step ahead of the submitting threads, before the
    queue ever held three: the window closed on a loaded host."""
    engine = _engine(0, lc.model_version_token(ckpt_a, 0))
    real_load = lc.load_reload_target
    burst_seen = threading.Event()

    def load_with_a_queue(target):
        deadline = time.monotonic() + 30
        while not (engine.active == 2 and engine.scheduler.depth >= 3):
            assert time.monotonic() < deadline, "the burst never queued"
            time.sleep(0.0005)
        burst_seen.set()
        return real_load(target)

    real_step = engine.step

    def step_then_hold():
        out = real_step()
        burst_seen.wait(30)
        return out

    monkeypatch.setattr(lc, "load_reload_target", load_with_a_queue)
    monkeypatch.setattr(engine, "step", step_then_hold)
    results, lock = [], threading.Lock()
    srv = LMServer(engine)  # started once the burst is queued

    def client(i):
        status, payload = srv.submit_and_wait(
            {"prompt_tokens": PROMPTS[i % len(PROMPTS)],
             "max_new_tokens": LONG_NEW})
        with lock:
            results.append((i, status, payload))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while engine.scheduler.depth < 6 and time.monotonic() < deadline:
        time.sleep(0.001)
    with srv:
        while engine.active == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        status, payload = srv.reload_model({"checkpoint_dir": ckpt_b})
        for t in threads:
            t.join(timeout=60)
        after = [srv.submit_and_wait({"prompt_tokens": p,
                                      "max_new_tokens": NEW})
                 for p in PROMPTS]
    assert status == 200 and payload["reloaded"], payload
    new = lc.model_version_token(ckpt_b, 0)
    assert payload["model_version"] == new
    assert payload["previous_version"] == lc.model_version_token(ckpt_a, 0)
    assert payload["invalidated_prefix"] is True
    assert {"verify_s", "load_s", "swap_s", "epoch"} <= set(payload)
    assert len(results) == 6
    assert all(s == 200 and p["status"] == "complete" for _, s, p in results)
    old = payload["previous_version"]
    assert {p["model_version"] for _, _, p in results} == {old, new}
    want = {v: _jax_streams(seed, new=LONG_NEW)
            for v, seed in ((old, 0), (new, 1))}
    for i, _, p in results:
        assert p["tokens"] == want[p["model_version"]][i % len(PROMPTS)], i
    assert all(s == 200 and p["model_version"] == new for s, p in after)
    assert [p["tokens"] for _, p in after] == _jax_streams(1)
    assert engine.reloads_total == 1 and engine.rollbacks_total == 0
    assert engine.stats()["lifecycle"] == {
        "model_version": new, "reloads_total": 1, "rollbacks_total": 0}


def test_same_version_keeps_the_prefix_index_new_version_flushes(
        ckpt_a, ckpt_b):
    engine = _engine(0, lc.model_version_token(ckpt_a, 0), page_size=PAGE)
    srv = LMServer(engine)  # driven in this thread: no engine loop
    before = [c.tokens for c in _run(engine, PROMPTS)]
    status, payload = srv.reload_model({"checkpoint_dir": ckpt_a})
    assert status == 200 and payload["invalidated_prefix"] is False
    again = _run(engine, PROMPTS)
    assert [c.tokens for c in again] == before
    assert all(c.prefix_hit_tokens == len(PREFIX) for c in again)
    status, payload = srv.reload_model({"checkpoint_dir": ckpt_b})
    assert status == 200 and payload["invalidated_prefix"] is True
    assert engine.page_stats()["pages_mapped"] == 0
    after = _run(engine, PROMPTS)
    assert after[0].prefix_hit_tokens == 0  # the flushed index misses
    assert [c.tokens for c in after] == _jax_streams(1)
    _close(srv)


REAL_CHUNK, REAL_SAMPLE = (engine_mod.prefill_chunk_device,
                           gen.sample_slot_tokens)


def _first_logits(engine):
    """Record, by request id, the logits each request's first token is
    drawn from (the final prefill chunk's)."""
    seen = {}
    real_chunk, real_sample = REAL_CHUNK, REAL_SAMPLE

    def chunk(*a, **kw):
        slot, final = int(a[7]), bool(a[11])
        if not final:
            return real_chunk(*a, **kw)

        def sample(logits, *sa, **skw):
            seen[engine._slots[slot].request.rid] = logits.clone()
            return real_sample(logits, *sa, **skw)

        gen.sample_slot_tokens = sample
        try:
            return real_chunk(*a, **kw)
        finally:
            gen.sample_slot_tokens = real_sample

    return seen, chunk


@pytest.mark.parametrize("invalidate", [True, False],
                         ids=["flushed", "stale_control"])
def test_stale_prefix_control_fails_the_check(monkeypatch, ckpt_b,
                                              invalidate):
    """A paged engine on A, traffic, then B installed as ``/reload``
    installs a new version (the flush) against the control that skips
    the flush. Held against a fresh engine on B fed the same schedule:
    the first logits bit for bit and the streams. The flushed engine
    passes; the control must fail (stale prefix K/V from A)."""
    state, _ = CheckpointManager(ckpt_b).restore_for_inference(0)
    swapped = _engine(0, "a", page_size=PAGE, slots=4)
    _run(swapped, PROMPTS, together=True)
    swapped.install_params(state, model_version="b",
                           invalidate_prefix=invalidate)
    fresh = _engine(1, "b", page_size=PAGE, slots=4)
    for eng in (swapped, fresh):  # the first request after the swap
        _run(eng, PROMPTS[:1])
    got = []
    for eng in (swapped, fresh):
        seen, chunk = _first_logits(eng)
        monkeypatch.setattr(engine_mod, "prefill_chunk_device", chunk)
        done = _run(eng, PROMPTS[1:], together=True)
        got.append(([c.tokens for c in done],
                    [seen[c.rid] for c in done],
                    [c.prefix_hit_tokens for c in done]))
    (streams, logits, hits), (want_streams, want_logits, want_hits) = got
    assert hits == want_hits == [len(PREFIX)] * (len(PROMPTS) - 1)
    same_bits = all(torch.equal(a, b) for a, b in zip(logits, want_logits))
    if invalidate:
        assert same_bits and streams == want_streams
    else:
        assert not same_bits, "the check passes a stale prefix"
        assert streams != want_streams


def _close(srv):
    """Release a server that was never started (``stop()`` would wait
    for a serve loop that never ran)."""
    srv._httpd.server_close()


@pytest.mark.parametrize("case", [
    "no_dir", "bad_epoch", "bad_drain_timeout", "unknown_model",
    "in_progress", "rejected", "load_failed", "drain_timeout",
    "swap_failed", "swapped"])
def test_reload_statuses(monkeypatch, tmp_path, ckpt_a, ckpt_b, case):
    """Every answer of ``POST /reload``, as the JAX server gives it."""
    engine = _engine(0, lc.model_version_token(ckpt_a, 0))
    srv = LMServer(engine, models={"other": _engine(1)})
    body = {"checkpoint_dir": ckpt_b}
    try:
        if case == "no_dir":
            assert srv.reload_model({})[0] == 400
        elif case in ("bad_epoch", "bad_drain_timeout"):
            key = case[4:]
            status, payload = srv.reload_model(dict(body, **{key: "x"}))
            assert status == 400 and "numeric" in payload["error"]
        elif case == "unknown_model":
            status, payload = srv.reload_model(dict(body, model="nope"))
            assert (status, payload["error"], payload["models"]) == (
                400, "unknown_model", ["other"])
        elif case == "in_progress":
            with srv._reload_lock:
                assert srv.reload_model(body) == (
                    409, {"error": "reload_in_progress"})
        elif case == "rejected":
            status, payload = srv.reload_model(
                {"checkpoint_dir": str(tmp_path)})
            assert status == 409 and payload["error"] == "manifest_missing"
        elif case == "load_failed":
            def broken(target):
                raise OSError("disk gone")

            monkeypatch.setattr(lc, "load_reload_target", broken)
            status, payload = srv.reload_model(body)
            assert status == 500 and payload["error"] == "load_failed"
            assert "disk gone" in payload["detail"]
        elif case == "drain_timeout":
            engine.submit(PROMPTS[0], NEW)
            engine.step()  # a bound lane that nothing steps further
            status, payload = srv.reload_model(dict(body, drain_timeout=0))
            assert status == 503 and payload["error"] == "swap_drain_timeout"
            assert not engine._admission_paused  # the door reopened
        elif case == "swap_failed":
            want = {k: v.clone() for k, v in engine.model.state_dict().items()}
            real, calls = torch.Tensor.copy_, [0]

            def copy_(self, src, *a, **kw):  # the 5th copy fails midway
                calls[0] += 1
                if calls[0] == 5:
                    raise RuntimeError("device copy failed")
                return real(self, src, *a, **kw)

            monkeypatch.setattr(torch.Tensor, "copy_", copy_)
            status, payload = srv.reload_model(body)
            monkeypatch.undo()
            assert (status, payload["error"], payload["rolled_back"]) == (
                500, "swap_failed", True)
            assert engine.model_version == lc.model_version_token(ckpt_a, 0)
            assert engine.rollbacks_total == 1 and engine.reloads_total == 0
            for k, v in engine.model.state_dict().items():
                assert torch.equal(v, want[k]), k
        else:
            status, payload = srv.reload_model(dict(body, epoch=0,
                                                    model="other"))
            assert status == 200 and payload["epoch"] == 0
            assert srv.models["other"].model_version == \
                lc.model_version_token(ckpt_b, 0)
            assert engine.reloads_total == 0  # the default engine untouched
    finally:
        _close(srv)
    if case != "swapped":
        assert engine.model_version == lc.model_version_token(ckpt_a, 0)


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_named_models_route_to_their_own_engine(ckpt_a, ckpt_b):
    default = _engine(0, lc.model_version_token(ckpt_a, 0))
    other = _engine(1, lc.model_version_token(ckpt_b, 0))
    with LMServer(default, models={"other": other}) as srv:
        body = {"prompt_tokens": PROMPTS[0], "max_new_tokens": NEW}
        _, _, p_def = _post(srv.url, body)
        before = default.tokens_emitted_total
        _, _, p_oth = _post(srv.url, dict(body, model="other"))
        assert default.tokens_emitted_total == before  # only other moved
        assert other.tokens_emitted_total == NEW
        status, _, p_bad = _post(srv.url, dict(body, model="nope"))
        health = json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                                   timeout=10).read())
    assert p_oth["tokens"] == _jax_streams(1, 1)[0]
    assert p_def["tokens"] == _jax_streams(0, 1)[0]
    assert p_oth["model_version"] == lc.model_version_token(ckpt_b, 0)
    assert (status, p_bad["error"], p_bad["models"]) == (
        400, "unknown_model", ["other"])
    assert health["models"]["other"]["model_version"] == \
        lc.model_version_token(ckpt_b, 0)
    assert health["draining"] is False


def test_drain_answers_503_while_running_requests_finish():
    engine = _engine(0, slots=2)
    with LMServer(engine, drain_retry_after=7) as srv:
        replies = []
        t = threading.Thread(target=lambda: replies.append(_post(
            srv.url, {"prompt_tokens": PROMPTS[0], "max_new_tokens": 20})))
        t.start()
        while engine.active == 0 and t.is_alive():
            time.sleep(0.001)
        srv.begin_drain()
        status, headers, payload = _post(
            srv.url, {"prompt_tokens": PROMPTS[1], "max_new_tokens": 2})
        assert srv.drain(30) is True
        t.join(timeout=60)
    assert (status, payload["error"], headers["Retry-After"]) == (
        503, "draining", "7")
    assert replies[0][0] == 200 and replies[0][2]["status"] == "complete"
    assert len(replies[0][2]["tokens"]) == 20


def test_sigterm_drains_the_serve_process():
    """SIGTERM to ``python -m ddp_tpu_torch.serve --device cpu``: the
    request in flight completes and the process exits 0. One torch
    thread and a generous drain timeout: a loaded host only slows it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--init_demo",
         "--device", "cpu", "--port", "0", "--slots", "2",
         "--drain_timeout", "300"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        url = json.loads(proc.stdout.readline())["serving"]
        replies = []
        t = threading.Thread(target=lambda: replies.append(_post(
            url, {"prompt_tokens": [1, 2, 3], "max_new_tokens": DRAIN_NEW})))
        t.start()
        while t.is_alive():
            health = json.loads(urllib.request.urlopen(
                url + "/healthz", timeout=10).read())
            if health["active"]:
                break
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert replies[0][0] == 200, (replies, out, err[-2000:])
    assert len(replies[0][2]["tokens"]) == DRAIN_NEW
    assert json.loads(out.splitlines()[-1]) == {
        "draining": True, "drained": True, "drain_timeout": 300.0}


@pytest.mark.parametrize("names,first", [
    (["embed", "pos_embed", "block1", "block2", "block3", "ln_final"], 2),
    (["ln_final", "block10", "block2", "embed", "block1", "pos_embed"], 1),
    (["embed", "mystery", "block1"], 0),
    (["block1", "block2"], 5),
])
def test_split_param_groups_equal_jax(names, first):
    assert lc.split_param_groups(names, first) == \
        jlc.split_param_groups(names, first)


def test_streaming_restore_serves_the_monolithic_streams(ckpt_b):
    streaming = lc.StreamingRestore(ckpt_b, device="cpu", first_blocks=1)
    assert streaming.admission_group == ["embed", "pos_embed", "block1"]
    assert streaming.deep_group == ["block2", "ln_final"]
    assert streaming.version == lc.model_version_token(ckpt_b, 0)
    engine = ServeEngine(
        CausalLM.from_state(streaming.spec, streaming.placeholder_state(),
                            "cpu"), slots=2, prefill_len=16,
        model_version=streaming.version)
    engine.pause_admission()
    streaming.start()
    assert streaming.wait_admission(60)
    rid = engine.submit(PROMPTS[0], NEW).request.rid
    engine.step()  # queued against the paused engine, never bound
    assert engine.active == 0 and engine.scheduler.depth == 1
    full = streaming.wait(60)
    assert streaming.admission_ready_s <= streaming.complete_s
    state, _ = CheckpointManager(ckpt_b).restore_for_inference()
    assert all(torch.equal(full[k], v) for k, v in state.items())
    engine.install_params(full, model_version=streaming.version)
    engine.resume_admission()
    engine.run()
    streamed = [engine.pop_result(rid).tokens] + [
        c.tokens for c in _run(engine, PROMPTS[1:])]
    assert streamed == [c.tokens for c in _run(_engine(1), PROMPTS)]
