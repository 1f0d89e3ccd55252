#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ddp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card (nvidia-smi name and power limit), torch, CUDA and nvcc.
2. Build the CUDA kernels from ddp_tpu_torch/ops/csrc (one nvcc per
   source, started together) and print the build seconds.
3. Each kernel against its plain PyTorch version on the card, at the
   serving model's full width, a GQA shape and a ragged cache length;
   then the median time of kernel, plain version and the library
   yardstick (scaled_dot_product_attention, timed here only), beside
   the least time the card could take (the bound).
4. The serving slice end to end: the full-width causal LM (vocab 8192,
   d_model 1024, depth 8, 8 heads, total_len 256) from seeded random
   weights, ServeEngine(slots=8, prefill_len=128) behind LMServer on
   127.0.0.1, ten concurrent POST /generate requests (greedy and
   seeded sampling), once with fp32 and once with int8 KV. The launch
   counters are set to 0 just before each run and read just after;
   each run must launch its kernel decode steps x depth times. The
   greedy requests then run alone (a fixed schedule), through the
   kernel and through decode_attn="reference", and their streams must
   match (a divergence passes only where the top-2 logit gap at the
   first divergent token is below 1e-3). Last, torch.profiler reads
   the device busy share of steady decode steps.
5. A "kernels" JSON line, the card line, and the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # non-tensor-core fp32, H100 SXM data sheet
# Kernel vs plain version, fp32: both sum the same products, in another
# order (online softmax over 64-key tiles vs one softmax per row).
KERNEL_ATOL = 1e-4
# Greedy streams may part only at a near tie of the top-2 logits.
DIVERGENCE_GAP = 1e-3
FULL = dict(vocab_size=8192, total_len=256, d_model=1024, depth=8,
            num_heads=8)
SLOTS, PREFILL_LEN = 8, 128
REQUESTS = [  # (prompt_len, max_new_tokens, sampling)
    (5, 16, {}),
    (128, 128, {}),
    (37, 64, {}),
    (100, 100, {"temperature": 0.8, "top_p": 0.9, "seed": 1}),
    (64, 32, {}),
    (17, 128, {"temperature": 1.0, "seed": 2}),
    (128, 16, {}),
    (90, 48, {"temperature": 0.7, "top_p": 0.95, "seed": -3}),
    (9, 77, {}),
    (50, 120, {}),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- phase 3: kernels against their plain versions --------------------


def _inputs(torch, S, H, H_kv, Dh, L, pos, quantized, seed):
    """q and one layer's K/V slice of a 2-layer cache (read in place
    through strides, as the engine passes them)."""
    from ddp_tpu_torch.ops.decode import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(S, H, Dh, generator=g, device="cuda")
    kf = torch.randn(S, L, H_kv, Dh, generator=g, device="cuda")
    vf = torch.randn(S, L, H_kv, Dh, generator=g, device="cuda")
    dtype = torch.int8 if quantized else torch.float32
    k = torch.zeros(2, S, L, H_kv, Dh, dtype=dtype, device="cuda")
    v = torch.zeros_like(k)
    ks = vs = None
    if quantized:
        ks = torch.zeros(2, S, L, H_kv, device="cuda")
        vs = torch.zeros_like(ks)
        k[1], ks[1] = quantize_kv(kf)
        v[1], vs[1] = quantize_kv(vf)
        ks, vs = ks[1], vs[1]
    else:
        k[1], v[1] = kf, vf
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, k[1], v[1], pos_t, ks, vs


def _median_ms(torch, fn, *, n=50, reps=7):
    """Median device time of one call, from CUDA events around ``n``
    back-to-back calls. A sleep kernel queued first keeps the card busy
    while the host enqueues, so host overhead does not show as idle
    device time (the sleep is lengthened until it covers the enqueue)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        covered = not slept.query()
        torch.cuda.synchronize()
        if not covered and cycles < 2_000_000_000:
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _bound(S, H, H_kv, Dh, pos, L, quantized):
    """Least time on an H100 for one call: bytes (each input read once,
    the output written once; K/V only up to each lane's position) over
    the memory rate vs fp32 operations over the fp32 rate."""
    keys = sum(min(int(p) + 1, L) for p in pos)
    elem = 1 if quantized else 4
    nbytes = (
        S * H * Dh * 4  # q
        + 2 * keys * H_kv * Dh * elem  # live K and V rows
        + (2 * keys * H_kv * 4 if quantized else 0)  # their scales
        + S * 4  # pos
        + S * H * Dh * 4  # out
    )
    flops = 4 * keys * H * Dh  # q·k and p·v, a multiply-add each
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(torch) -> dict:
    import torch.nn.functional as F

    from ddp_tpu_torch.ops import decode as dec

    results = {}
    shapes = [  # name, S, H, H_kv, Dh, L
        ("full", 8, 8, 8, 128, 256),
        ("gqa", 8, 8, 2, 128, 256),
        ("ragged", 8, 8, 8, 128, 200),
    ]
    rng = np.random.default_rng(0)
    for quantized, name in ((False, "flash_decode_fp32"),
                            (True, "flash_decode_int8")):
        errs = []
        for label, S, H, H_kv, Dh, L in shapes:
            pos = rng.integers(0, L, S)
            pos[0], pos[1], pos[2] = 0, L - 1, L  # first key, last, ceiling
            args = _inputs(torch, S, H, H_kv, Dh, L, pos.tolist(), quantized,
                           seed=len(errs) + 10 * quantized)
            out = dec.flash_decode_attention(*args)
            ref = dec.decode_attention_reference(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            log(f"[kernels] {name} {label} S={S} H={H} H_kv={H_kv} "
                f"Dh={Dh} L={L}: max_abs_err {err:.3e} "
                f"(tolerance {KERNEL_ATOL})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"{name} {label}: error {err}")
            errs.append(err)
        # Timing at the main path's shapes: full width, every lane at
        # the last position (a full cache read).
        S, H, H_kv, Dh, L = 8, 8, 8, 128, 256
        pos = [L - 1] * S
        q, k, v, pos_t, ks, vs = _inputs(torch, S, H, H_kv, Dh, L, pos,
                                         quantized, seed=99)
        kf = dec.dequantize_kv(k, ks) if quantized else k
        vf = dec.dequantize_kv(v, vs) if quantized else v
        q4 = q[:, :, None, :]
        k4 = kf.permute(0, 2, 1, 3).contiguous()
        v4 = vf.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(L, device="cuda")[None, :]
                <= pos_t[:, None])[:, None, None, :]

        gqa = {"enable_gqa": True} if H != H_kv else {}

        def library():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, **gqa)

        lib_err = float(
            (library()[:, :, 0] - dec.decode_attention_reference(
                q, k, v, pos_t, ks, vs)).abs().max())
        ms = _median_ms(torch, lambda: dec.flash_decode_attention(
            q, k, v, pos_t, ks, vs))
        plain_ms = _median_ms(torch, lambda: dec.decode_attention_reference(
            q, k, v, pos_t, ks, vs))
        library_ms = _median_ms(torch, library)
        bound_ms, bound_by = _bound(S, H, H_kv, Dh, pos, L, quantized)
        log(f"[kernels] {name} full width, pos={L - 1} on every lane: "
            f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"sdpa {library_ms * 1e3:.2f} us (its error vs plain "
            f"{lib_err:.1e}), bound {bound_ms * 1e3:.2f} us ({bound_by})")
        results[name] = dict(
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )
    return results


# ---- phase 4: the serving slice end to end ----------------------------


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.loads(r.read())


def serve_run(torch, model, prompts, *, kv_dtype):
    """Serve every request of REQUESTS over HTTP, concurrently, on the
    kernel path → (completions by index, engine)."""
    from ddp_tpu_torch.serve.engine import ServeEngine
    from ddp_tpu_torch.serve.server import LMServer

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         kv_dtype=kv_dtype)
    results: dict[int, dict] = {}
    errors: list[str] = []
    with LMServer(engine) as server:
        def client(i):
            plen, n_new, sampling = REQUESTS[i]
            try:
                results[i] = _post(server.url, {
                    "prompt_tokens": prompts[i], "max_new_tokens": n_new,
                    **sampling})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(REQUESTS))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish")
    torch.cuda.synchronize()
    if errors:
        raise AssertionError("; ".join(errors))
    for i, (plen, n_new, _) in enumerate(REQUESTS):
        r = results[i]
        if r["status"] != "complete" or len(r["tokens"]) != n_new:
            raise AssertionError(
                f"request {i}: {r['status']}, {len(r['tokens'])}/{n_new}")
        if not all(0 <= t < FULL["vocab_size"] for t in r["tokens"]):
            raise AssertionError(f"request {i}: token out of the vocab")
    decode_tokens = sum(len(r["tokens"]) - 1 for r in results.values())
    log(f"[serve] kv={kv_dtype} attn={engine.decode_attn}: "
        f"{len(REQUESTS)} requests complete in {wall:.3f} s, "
        f"{engine.decode_steps} decode steps, decode {decode_tokens / wall:.1f} "
        f"tokens/s, TTFT p50 {engine.ttft.percentile(50) * 1e3:.1f} ms, "
        f"step latency p50 {engine.step_latency.percentile(50) * 1e3:.2f} ms "
        f"p99 {engine.step_latency.percentile(99) * 1e3:.2f} ms")
    return results, engine


def lone_streams(torch, model, prompts, picks, *, kv_dtype, decode_attn):
    """Each request of ``picks`` served alone, in-process, one after the
    other → {index: tokens}. A lone request's schedule (its prompt's
    chunk split) is the same on every run, so two runs differ only in
    their decode attention. Under concurrency it is not: a first chunk
    attends its own unquantized K/V and later chunks the dequantized
    lane, so int8 streams legitimately depend on the arrival order."""
    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         kv_dtype=kv_dtype, decode_attn=decode_attn)
    out = {}
    for i in picks:
        rid = engine.submit(prompts[i], REQUESTS[i][1]).request.rid
        engine.run()
        c = engine.pop_result(rid)
        if c.status != "complete" or len(c.tokens) != REQUESTS[i][1]:
            raise AssertionError(f"lone request {i}: {c.status}")
        out[i] = c.tokens
    return out


def replay_gap(torch, model, prompt, stream, j, kv_dtype) -> float:
    """Top-2 logit gap of the plain path at token ``j`` (>= 1) of a lone
    request: the engine's chunk plan for the prompt, then one plain
    decode step per earlier token, on a one-slot cache."""
    from ddp_tpu_torch.models.generate import (
        init_slot_cache,
        prefill_chunk,
        slot_decode_step,
    )
    from ddp_tpu_torch.serve.engine import resolve_engine_knobs
    from ddp_tpu_torch.serve.scheduler import Scheduler

    if j < 1:
        raise AssertionError("streams part at the first token, which "
                             "prefill computes alike on both paths")
    spec, dev = model.spec, model.device
    knobs = resolve_engine_knobs(spec, device=dev, slots=SLOTS,
                                 prefill_len=PREFILL_LEN)
    sched = Scheduler(max_queue=1, prefill_len=PREFILL_LEN,
                      total_len=spec.total_len, chunk=knobs["chunk"],
                      min_bucket=knobs["min_bucket"],
                      token_budget=knobs["step_token_budget"])
    cache = init_slot_cache(
        spec, 1, device=dev,
        dtype=torch.int8 if kv_dtype == "int8" else torch.float32)
    state = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(3)]
    state += [torch.zeros(1, device=dev), torch.ones(1, device=dev)]
    start = 0
    while start < len(prompt):
        [(_, width)] = sched.plan_chunks([(0, start, len(prompt) - start)], 0)
        live = min(width, len(prompt) - start)
        buf = torch.zeros(width, dtype=torch.int64)
        buf[:live] = torch.tensor(prompt[start:start + live])
        prefill_chunk(model, cache, *state, 0, buf.to(dev), start, live,
                      start + live == len(prompt), 0, 0.0, 1.0,
                      lane_attend=start != 0)
        start += live
    for t in stream[:j]:
        logits = slot_decode_step(model, cache, torch.tensor([t], device=dev),
                                  attn_impl="reference")
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def profile_steps(torch, model, *, steps=16) -> None:
    """Device busy share of steady decode steps (all 8 lanes decoding,
    fp32 KV, kernel path), from torch.profiler: summed CUDA kernel time
    over the wall time of ``steps`` engine steps, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN)
    rng = np.random.default_rng(2)
    for _ in range(SLOTS):
        engine.submit(rng.integers(0, model.spec.vocab_size, 64).tolist(), 64)
    for _ in range(8):  # prefill done, every lane decoding
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        log("[profile] torch.profiler reported no device time")
        return
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {steps} decode steps, 8 lanes, fp32 KV: wall "
        f"{wall * 1e3:.2f} ms, device kernel time {busy_us / 1e3:.2f} ms, "
        f"busy share {busy_us / 1e6 / wall:.3f}")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / steps:9.1f} us/step "
            f"x{e.count // steps:<3d} {e.key[:90]}")


def check_serving(torch) -> dict:
    from ddp_tpu_torch.models.lm import LMSpec, init_lm
    from ddp_tpu_torch.ops import decode as dec

    spec = LMSpec(**FULL)
    t0 = time.perf_counter()
    model = init_lm(spec, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model {spec} — {n_params / 1e6:.1f} M params, built on "
        f"{model.device} in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        probe = model(torch.arange(16, device=model.device)[None])
    if probe.shape != (1, 16, spec.vocab_size) or not bool(
            torch.isfinite(probe).all()):
        raise AssertionError("dense forward gave bad logits")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    launches = dec.flash_decode_attention.launches
    counted = {}
    for kv_dtype, name in (("fp32", "flash_decode_fp32"),
                           ("int8", "flash_decode_int8")):
        for k in launches:
            launches[k] = 0
        _, engine = serve_run(torch, model, prompts, kv_dtype=kv_dtype)
        got = dict(launches)
        want = engine.decode_steps * spec.depth
        log(f"[serve] kv={kv_dtype} launches {got} (decode steps x depth "
            f"= {want})")
        if engine.decode_attn != "flash" or got[name] < want or want == 0:
            raise AssertionError(f"{name}: {got[name]} launches < {want}")
        if sum(got.values()) != got[name]:
            raise AssertionError(f"unexpected launches {got}")
        counted[name] = got[name]
    greedy = [i for i, (_, _, s) in enumerate(REQUESTS) if not s]
    for kv_dtype in ("fp32", "int8"):
        kernel = lone_streams(torch, model, prompts, greedy,
                              kv_dtype=kv_dtype, decode_attn="flash")
        for k in launches:
            launches[k] = 0
        plain = lone_streams(torch, model, prompts, greedy,
                             kv_dtype=kv_dtype, decode_attn="reference")
        if any(launches.values()):
            raise AssertionError(f"the reference path launched {launches}")
        parted = 0
        for i in greedy:
            a, b = kernel[i], plain[i]
            if a == b:
                continue
            parted += 1
            j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = replay_gap(torch, model, prompts[i], b, j, kv_dtype)
            log(f"[serve] kv={kv_dtype} request {i}: kernel and plain "
                f"streams part at token {j}; top-2 logit gap {gap:.3e}")
            if gap >= DIVERGENCE_GAP:
                raise AssertionError(f"request {i} diverged at gap {gap}")
        log(f"[serve] kv={kv_dtype}: {len(greedy)} greedy requests served "
            f"alone through the kernel and the plain decode path: "
            f"{len(greedy) - parted} streams identical, {parted} parted at "
            f"a near tie")
    profile_steps(torch, model)
    return counted


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from ddp_tpu_torch.ops import _build
    from ddp_tpu_torch.ops import decode as dec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), nvcc: "
        f"{nvcc.stdout.strip().splitlines()[-1]}")

    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"[build] {json.dumps(seconds)} (wall {time.perf_counter() - t0:.2f} s)")

    timings = check_kernels(torch)
    launches = check_serving(torch)

    replaces = {"flash_decode_fp32": "ddp_tpu/ops/decode.py:260",
                "flash_decode_int8": "ddp_tpu/ops/decode.py:270"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": "ddp_tpu_torch/ops/csrc/flash_decode.cu",
         "replaces": replaces[name], "launches": launches[name],
         **timings[name]}
        for name in ("flash_decode_fp32", "flash_decode_int8")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
