#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ddp_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-flash | --time-decode [--root DIR]

The second form only times B1-B3 or B4/B5 of the package under DIR
(time_flash_main, time_decode_main). The first runs these phases, in
order; any failure exits non-zero and prints no result:

1. The card (nvidia-smi name and power limit), torch, CUDA and nvcc.
2. Build the CUDA kernels from ddp_tpu_torch/ops/csrc (one nvcc per
   source, started together), print the build seconds and, from ptxas's
   report, each flash-attention and flash-decode kernel's registers,
   shared memory and spill bytes (a spill raises).
3. The flash-decode kernels B4 (fp32 K/V) and B5 (int8 K/V) against their
   plain PyTorch version on the card (KERNEL_ATOL), at the serving
   model's full width, a GQA shape, a ragged cache length and a long
   cache (L 8192, random positions and every lane at L-1), with lanes at
   the first key, inside the first chunk, at the last key and at the
   position ceiling; each result the same bits on a second call and with
   every cache row past the band poisoned with NaN (never read); the
   kernel's split emulated with one chunk dropped must fail the check;
   shapes the kernel does not take route to the plain version (counted)
   and an explicit kernel call on them raises. Then, at L 256 and L 8192
   with every lane at L-1, the median time of kernel, plain version and
   the library yardstick (scaled_dot_product_attention with the band
   mask, timed here only), beside the least time the card could take
   (the bound).
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
3b. (Runs after 4, so that its large allocations come after the serving
   run's timings.) The flash-attention kernels B1 (forward), B2 (dQ) and
   B3 (dK/dV), bf16 and fp32, against their plain versions: out, lse and
   the three gradients through autograd (random dO, nonzero dLSE), then
   B2 and B3 alone, at full width causal and non-causal, T < S, T > S
   (empty rows), a ragged T, head dim 64 and head dim 96 (a padded
   head-dim tile), each tensor held to a relative norm error and an
   element-wise atol + rtol·|want| (FLASH_TOL); two wrong attentions (a
   dropped interior tile, a dropped ragged tail) must fail the same
   check; B1, B2 and B3 run twice on the same inputs must agree bit for
   bit (no atomics). Then B2's ptxas report, kernel, plain and SDPA
   times beside the bound at the training shape (in fp32 also SDPA's
   kernel names and its error against the plain version: the
   yardstick's own numerics), and fwd+bwd kernel vs plain per length
   (the data for re-measuring FLASH_MIN_LEN).
5a. The causal LM at head dim 24, which B1-B3 do not take, trains a
   step or two on the card through the plain block (counted, no kernel
   launch, finite losses).
5. The training slice end to end: ``python -m ddp_tpu_torch.train``'s
   own main() at the repo's full-width training configuration (bench.py
   run_lm_bench: 111.3 M params, T 2048, batch 8, Adam 3e-4, bf16), 12
   steps and an eval each epoch, launch counters set to 0 before and
   read after (each of B1-B3 at least depth x steps times, no block
   routed to the plain block), finite
   losses falling from epoch 1 to 2, a torch.profiler read of steady
   steps, and one step through the kernels vs the plain attention from
   the same weights and batch (loss, whole gradient and every parameter's
   gradient, STEP_TOL; a B3 that drops a dK tile must fail the same
   limits); then the fp32 variant at depth 2.
6. The reference trainer's main path (train.py --epochs 3 --batch_size
   64, which BASELINE.json measures): ``python -m ddp_tpu_torch.train
   --model simple_cnn``'s own main() on the synthetic split at MNIST's
   full size (60,000 / 10,000), SimpleCNN at full width (32, 64), world 1
   over nccl, SGD 0.01 with momentum 0.9 (so the restored optimizer
   state has buffers). No kernel of the repo lies on it (its convs and
   linear are cuDNN's and cuBLAS's through torch).
   6a: 3 epochs, losses finite and falling, epoch_0..2 with verified
   manifests, final_accuracy= printed; the same command again restores
   epoch 2's parameters, step count and momentum buffers bit for bit;
   --epochs 4 prints "Resumed from checkpoint epoch 2" and trains epoch 3
   alone; one flipped byte in epoch_3's state file, then --epochs 5:
   quarantine.epoch-3 appears and training resumes from epoch 2.
   6b: one epoch through --fast_epoch against one through the loader on
   the same plan, deterministic cuDNN: parameters within FAST_ATOL.
   6c: one step on the card (fp32, TF32 off) against the same step on
   the CPU, from the same weights and batch (CNN_STEP_TOL: loss, whole
   gradient, worst leaf gradient and worst updated parameter); the same
   at a forced world of 2 in-process; a world-2 average divided by the
   world twice must fail the limits.
   6d: the reference recipe (SGD 0.01, batch 32, 3 epochs) on the
   vendored uci_digits: its test accuracy, a reading.
   6e: --spawn 2 --backend gloo, both ranks on the one card at batch 32
   each, against world 1 at batch 64 on the same plan (SPAWN_ATOL).
   Timing, with the card's name and power limit: images/s per card, step
   p50 (CUDA events) and the busy share of one more epoch under
   torch.profiler, for the step and fast paths at batch 64 and at global
   batch 16384 (bench.py's), and the fast path at 16384 in bf16.
7. A "kernels" JSON line, the card line, and the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # non-tensor-core fp32, H100 SXM data sheet
# Kernel vs plain version, fp32: both sum the same products, in another
# order (online softmax per row group, merged over warps and over the
# split's chunks, vs one softmax per row).
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


DECODE_SHAPES = [  # label, S, H, H_kv, Dh, L
    ("full", 8, 8, 8, 128, 256),
    ("gqa", 8, 8, 2, 128, 256),
    ("ragged", 8, 8, 8, 128, 200),
    ("long cache", 8, 8, 8, 128, 8192),
]
DECODE_TIMED_L = (256, 8192)  # the serving cache, and a long one past L2


def _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized):
    """(keys a chunk, chunks) of the kernel's split at this shape."""
    G = H // H_kv
    y = H_kv * -(-G // dec.group_tile(G))
    return dec.split_plan(L, S * y, dec._sm_count(torch.cuda.current_device()),
                          torch.int8 if quantized else torch.float32, Dh)


def _decode_positions(rng, S, L, chunk):
    """Random lane positions, and four set ones: the first key, a band
    that ends inside the first chunk (every later chunk lies past it),
    the last key and the position ceiling (pos == L: every key)."""
    pos = rng.integers(0, L, S)
    pos[:4] = 0, min(chunk, L) // 2, L - 1, L
    return pos.tolist()


def _poisoned(torch, args):
    """The same inputs with every cache row past its lane's band (key >
    pos, key < L) made NaN (fp32 K/V; int8: the rows' scales), copied."""
    q, k, v, pos, ks, vs = args
    L = k.shape[1]
    dead = torch.arange(L, device="cuda")[None, :] > pos[:, None].long()
    if ks is None:
        k, v = k.clone(), v.clone()
        k[dead], v[dead] = float("nan"), float("nan")
    else:
        ks, vs = ks.clone(), vs.clone()
        ks[dead], vs[dead] = float("nan"), float("nan")
    return q, k, v, pos, ks, vs


def _reject_dropped_chunk(torch, dec, args, want, label) -> list[str]:
    """Negative control: the kernel's split emulated on the card
    (ops/decode.decode_split_partials and merge_split_partials, the
    kernel's chunks) must pass phase 3's check, and the same merge with
    chunk 1 dropped must fail it → what did not."""
    q, k = args[:2]
    chunk, n = _decode_plan(torch, dec, *q.shape[:2], *k.shape[2:],
                            k.shape[1], k.dtype == torch.int8)
    if n < 2:
        return [f"{label}: one chunk, so no merge to control"]
    o, lse = dec.decode_split_partials(*args, chunk=chunk)
    good = float((dec.merge_split_partials(o, lse) - want).abs().max())
    lse[..., 1] = float("-inf")
    bad = float((dec.merge_split_partials(o, lse) - want).abs().max())
    log(f"[kernels] control {label}, split emulated ({n} chunks of "
        f"{chunk}): max_abs_err {good:.3e}; chunk 1 dropped: {bad:.3e} "
        f"(tolerance {KERNEL_ATOL})")
    failed = [] if good <= KERNEL_ATOL else [f"{label}: the emulated split "
                                             f"fails ({good})"]
    if bad <= KERNEL_ATOL:
        failed.append(f"{label}: the check passes a merge that drops a chunk")
    return failed


def _time_decode(torch, F, dec, quantized, L) -> dict:
    """Kernel, plain version and SDPA (with the band mask) times at full
    width, every lane at pos L-1 (a full cache read), beside the bound."""
    _, S, H, H_kv, Dh, _ = DECODE_SHAPES[0]
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
    del kf, vf

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    lib_err = float((library()[:, :, 0] - dec.decode_attention_reference(
        q, k, v, pos_t, ks, vs)).abs().max())
    ms = _median_ms(torch, lambda: dec.flash_decode_attention(
        q, k, v, pos_t, ks, vs))
    plain_ms = _median_ms(torch, lambda: dec.decode_attention_reference(
        q, k, v, pos_t, ks, vs), n=10, reps=5)
    library_ms = _median_ms(torch, library, n=20)
    bound_ms, bound_by = _bound(S, H, H_kv, Dh, pos, L, quantized)
    chunk, n = _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized)
    log(f"[kernels] {'int8' if quantized else 'fp32'} S={S} H={H} "
        f"H_kv={H_kv} Dh={Dh} L={L}, pos={L - 1} on every lane ({n} chunks "
        f"of {chunk} keys): kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us (its "
        f"error vs plain {lib_err:.1e}), bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}), {bound_ms / ms:.3f} of the bound")
    del q, k, v, ks, vs, q4, k4, v4
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _check_decode_routing(torch, dec) -> list[str]:
    """Shapes the kernel does not take (fp32 head dim 320, int8 head dim
    24): ``auto`` takes the plain version on the card and counts it, no
    launch; an explicit kernel call raises → what did not hold."""
    failed = []
    for quantized, Dh in ((False, 320), (True, 24)):
        args = _inputs(torch, 2, 4, 2, Dh, 64, [5, 64], quantized, seed=3)
        before, routed = dict(dec.flash_decode_attention.launches), \
            dec.flash_decode_attention.plain_routed
        got = dec.decode_attention(*args, impl="auto")
        ok = (torch.equal(got, dec.decode_attention_reference(*args))
              and dec.flash_decode_attention.plain_routed == routed + 1
              and dec.flash_decode_attention.launches == before)
        try:
            dec.flash_decode_attention(*args)
            raised = False
        except ValueError:
            raised = True
        log(f"[kernels] {'int8' if quantized else 'fp32'} head dim {Dh} "
            f"(not taken): auto routed to the plain version and counted: "
            f"{ok}; an explicit kernel call raises: {raised}")
        if not (ok and raised):
            failed.append(f"routing at head dim {Dh}")
    return failed


def check_kernels(torch) -> dict:
    """Phase 3: B4 and B5 against the plain version at every shape of
    DECODE_SHAPES (positions from _decode_positions; the long cache also
    with every lane at L-1), KERNEL_ATOL; the same bits again on a second
    call and with every row past the band poisoned (never read); the
    split emulated with a chunk dropped must fail the check; the routing
    of shapes the kernel does not take; then times at L 256 and L 8192.
    Every reading is printed before a failure is raised."""
    import torch.nn.functional as F

    from ddp_tpu_torch.ops import decode as dec

    for quantized in (False, True):
        dtype = torch.int8 if quantized else torch.float32
        taken = dec._lib().flash_decode_tile_keys(int(quantized), 128)
        if taken != dec.tile_keys(dtype, 128):
            raise AssertionError(f"tile keys: kernel {taken}, wrapper "
                                 f"{dec.tile_keys(dtype, 128)}")
    results, failed = {}, []
    rng = np.random.default_rng(0)
    for quantized, name in ((False, "flash_decode_fp32"),
                            (True, "flash_decode_int8")):
        errs = []
        cases = []
        for label, S, H, H_kv, Dh, L in DECODE_SHAPES:
            chunk, _ = _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized)
            cases.append((label, S, H, H_kv, Dh, L,
                          _decode_positions(rng, S, L, chunk)))
        _, S, H, H_kv, Dh, L = DECODE_SHAPES[-1]
        cases.append(("long cache, every lane at L-1", S, H, H_kv, Dh, L,
                      [L - 1] * S))
        for i, (label, S, H, H_kv, Dh, L, pos) in enumerate(cases):
            args = _inputs(torch, S, H, H_kv, Dh, L, pos, quantized,
                           seed=i + 10 * quantized)
            out = dec.flash_decode_attention(*args)
            again = dec.flash_decode_attention(*args)
            poisoned = dec.flash_decode_attention(*_poisoned(torch, args))
            ref = dec.decode_attention_reference(*args)
            torch.cuda.synchronize()
            chunk, n = _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized)
            err = float((out - ref).abs().max())
            same, clean = torch.equal(out, again), torch.equal(out, poisoned)
            log(f"[kernels] {name} {label} S={S} H={H} H_kv={H_kv} "
                f"Dh={Dh} L={L} ({n} chunks of {chunk}), pos "
                f"{pos[:4]}...: max_abs_err {err:.3e} (tolerance "
                f"{KERNEL_ATOL}); bitwise equal on a second call: {same}; "
                f"rows past the band poisoned, same bits: {clean}")
            if not (err <= KERNEL_ATOL and same and clean):
                failed.append(f"{name} {label}")
            errs.append(err)
            if label in ("full", "long cache, every lane at L-1") and n > 1:
                failed += _reject_dropped_chunk(torch, dec, args, ref,
                                                f"{name} {label}")
            del args, out, again, poisoned, ref
            torch.cuda.empty_cache()
        short, long = (_time_decode(torch, F, dec, quantized, L)
                       for L in DECODE_TIMED_L)
        results[name] = dict(max_abs_err=max(errs), **short,
                             long_cache=dict(L=DECODE_TIMED_L[1], **long))
    failed += _check_decode_routing(torch, dec)
    if failed:
        raise AssertionError(f"decode kernels: {failed}")
    return results


def time_decode_kernels(torch) -> dict:
    """B4 and B5 kernel times (medians of 5 x 20 calls) at full width,
    every lane at pos L-1, for each L of DECODE_TIMED_L → {"fp32" |
    "int8": {L: ms}}: the reading that compares two trees in one call
    (``--time-decode [--root DIR]``)."""
    from ddp_tpu_torch.ops import decode as dec

    out = {}
    for quantized in (False, True):
        row = {}
        for L in DECODE_TIMED_L:
            args = _inputs(torch, 8, 8, 8, 128, L, [L - 1] * 8, quantized,
                           seed=99)
            row[L] = _median_ms(torch, lambda: dec.flash_decode_attention(
                *args), n=20, reps=5)
            del args
            torch.cuda.empty_cache()
        out["int8" if quantized else "fp32"] = row
    return out


# ---- phase 3b: flash attention B1-B3 against their plain versions ---------

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
H100_TF32_FLOPS = 494.7e12  # dense tensor-core TF32, H100 SXM data sheet
# Each tensor is held to both limits: its relative norm error
# |got - want| / |want| <= rel, and every element |got - want| <= atol +
# rtol·|want|. fp32: kernel and plain version sum the same products in
# another order. bf16: the kernel (bf16 tiles, P and dS rounded to bf16
# for their products, bf16 outputs) against the plain version run in fp32
# on the same bf16 inputs.
FLASH_TOL = {"fp32": dict(rel=1e-5, atol=1e-4, rtol=0.0),
             "bf16": dict(rel=1e-2, atol=1e-2, rtol=2e-2)}
FLASH_SHAPES = [  # label, B, T, S, H, D, causal
    ("full causal", 8, 2048, 2048, 8, 128, True),
    ("full non-causal", 8, 2048, 2048, 8, 128, False),
    ("causal T<S", 2, 512, 1536, 8, 128, True),
    ("causal T>S (empty rows)", 2, 1536, 512, 8, 128, True),
    ("causal ragged T=S=1000", 2, 1000, 1000, 8, 128, True),
    ("causal head dim 64", 2, 1024, 1024, 16, 64, True),
    ("causal head dim 96", 2, 512, 512, 8, 96, True),
]
FLASH_NAMES = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")
# The device functions of flash_attn.cu (B1-B3: the sm90 kernels in bf16,
# the three-pass TF32 kernels in fp32), as profiler keys and ptxas entries
# name them.
FLASH_SYMBOLS = ("fwd_sm90", "dq_sm90", "dkv_sm90", "fwd_tf32", "dq_tf32",
                 "dkv_tf32")
# Kernels built to keep every accumulator in registers: a spill raises.
# Every flash kernel is one.
REGISTER_KERNELS = FLASH_SYMBOLS


def _flash_inputs(torch, B, T, S, H, D, dtype, seed):
    """q/k/v as the model hands them over: strided views of one fused
    [B, T, H, 3, D] projection when T == S (token stride 3·H·D), else
    separate tensors; plus dO and a nonzero dLSE."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if T == S:
        qkv = rnd(B, T, H, 3, D)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    else:
        q, k, v = rnd(B, T, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    return q, k, v, rnd(B, T, H, D), torch.randn(B, T, H, generator=g,
                                                  device="cuda")


def _compare(torch, got, want, tol) -> tuple[bool, str]:
    """got vs want under ``tol`` → (within both limits, a reading): the
    relative norm error, the worst element's share of atol + rtol·|want|,
    and want's scale (max and median |want|). Equal infinities (an empty
    row's lse) count as equal; an infinity against a finite value, or a
    NaN, fails."""
    got, want = got.detach().float(), want.detach().float()
    finite = torch.isfinite(want)
    diff = torch.where(finite, (got - want).abs(),
                       torch.where(got == want, 0.0, float("inf")))
    mag = torch.where(finite, want.abs(), 0.0)
    rel = float(torch.where(finite, diff, 0.0).norm() / mag.norm())
    share = float((diff / (tol["atol"] + tol["rtol"] * mag)).max())
    ok = rel <= tol["rel"] and share <= 1.0
    return ok, (f"rel {rel:.2e} worst {share:.2f} (max|d| "
                f"{float(diff.max()):.2e}, |want| max {float(mag.max()):.3g} "
                f"median {float(mag[finite].median()):.2e})")


def _with_grads(torch, fn, q, k, v, dout, dlse):
    """fn(q, k, v) -> (out, lse) on fresh leaves → out, lse and the three
    gradients for the cotangents (dO, dLSE)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out, lse = fn(*leaves)
    grads = torch.autograd.grad((out, lse), leaves,
                                (dout.to(out.dtype), dlse))
    return dict(out=out.detach(), lse=lse.detach(), dq=grads[0],
                dk=grads[1], dv=grads[2])


def _masked_attention(torch, mask):
    """Dense fp32 attention → (out, lse) under an explicit [T, S] mask:
    a kernel that attends the wrong keys, for the negative controls."""
    def fn(q, k, v):
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        s = (s * q.shape[-1] ** -0.5).masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", torch.exp(s - lse[..., None]),
                           v.float())
        return out, lse.transpose(1, 2)
    return fn


def _reject_wrong_kernels(torch, fl, dtype, dname) -> list[str]:
    """Negative controls: the phase-3b check must reject an attention
    that is wrong by a typical amount. At the ragged shape (B 2, T = S
    1000, H 8, D 128, causal), a dense attention that drops one interior
    64-key tile (keys 512-575 for queries 576 on), or the off-diagonal
    keys of the ragged last tile (queries 960-999 see keys < 960 and
    themselves), is held against the plain version as the kernel is; each
    of out, dq, dk and dv must fail → what did not."""
    B, T, H, D = 2, 1000, 8, 128
    q, k, v, dout, dlse = _flash_inputs(torch, B, T, T, H, D, dtype, seed=4)
    want = _with_grads(
        torch, lambda *a: fl.attention_with_lse_reference(*a, True),
        q.float(), k.float(), v.float(), dout.float(), dlse)
    idx = torch.arange(T, device="cuda")
    causal = idx[:, None] >= idx[None, :]
    tile = causal.clone()
    tile[576:, 512:576] = False
    ragged = causal.clone()
    ragged[960:, 960:] = torch.eye(T - 960, dtype=torch.bool, device="cuda")
    tol = FLASH_TOL[dname]
    failed = []
    for label, mask in (("interior tile 512-575 dropped", tile),
                        ("ragged last tile's off-diagonal keys dropped",
                         ragged)):
        got = _with_grads(torch, _masked_attention(torch, mask), q, k, v,
                          dout, dlse)
        parts, passed = [], []
        for what in ("out", "dq", "dk", "dv"):
            ok, text = _compare(torch, got[what], want[what], tol)
            parts.append(f"{what} {text}")
            if ok:
                passed.append(what)
        log(f"[flash] {dname} control, {label}: " + "; ".join(parts))
        if passed:
            failed.append(f"the check passes a wrong attention ({label}): "
                          f"{passed}")
    return failed


def _check_deterministic(torch, fl, dtype, dname) -> list[str]:
    """B1, B2 and B3 twice on the same inputs (the training shape, causal)
    must give the same bits: no atomics, no order that changes between
    runs → what differed."""
    q, k, v, dout, _ = _flash_inputs(torch, 8, 2048, 2048, 8, 128, dtype,
                                     seed=7)
    runs = []
    for _ in range(2):
        out, lse = fl.flash_forward(q, k, v, True)
        delta = fl.backward_delta(out, dout)
        dq = fl.flash_dq(q, k, v, dout, lse, delta, True)
        dk, dv = fl.flash_dkv(q, k, v, dout, lse, delta, True)
        runs.append(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv))
    torch.cuda.synchronize()
    differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    log(f"[flash] {dname} B1, B2 and B3 run twice at the training shape: "
        + (f"differ in {differ}" if differ else "bitwise equal"))
    del q, k, v, dout, runs
    torch.cuda.empty_cache()
    return [f"not deterministic: {differ}"] if differ else []


def _flash_counts(B, T, S, H, D, causal, elem):
    """(live (query, key) pairs, bytes of each kernel's inputs and
    outputs read or written once) at this shape."""
    if causal:
        pairs = sum(max(0, min(S, t + 1 + S - T)) for t in range(T))
    else:
        pairs = T * S
    pairs *= B * H
    qo = B * T * H * D * elem  # q, out, dO or dq
    kv = B * S * H * D * elem  # k, v, dk or dv
    row = B * T * H * 4  # lse or delta
    nbytes = {
        "flash_attn_fwd": 2 * qo + 2 * kv + row,
        "flash_attn_dq": 3 * qo + 2 * kv + 2 * row,
        "flash_attn_dkv": 2 * qo + 4 * kv + 2 * row,
    }
    return pairs, nbytes


def _flash_bound(name, pairs, nbytes, D, dtype_name):
    """Least time on an H100: tile products (2 flops a multiply-add;
    B1 does 2 products, B2 3, B3 4, over the live pairs) at the fastest
    rate that keeps the dtype's accuracy, vs the bytes over the memory
    rate. bf16: the tensor cores' bf16 peak. fp32: the faster of the FMA
    units (67 TFLOP/s) and three TF32 passes a product on the tensor
    cores (494.7 / 3 TFLOP/s), whatever design runs the kernel."""
    products = {"flash_attn_fwd": 2, "flash_attn_dq": 3,
                "flash_attn_dkv": 4}[name]
    flops = 2 * products * pairs * D
    if dtype_name == "bf16":
        t_ops = flops / H100_BF16_FLOPS
    else:
        t_ops = min(flops / H100_FP32_FLOPS, 3 * flops / H100_TF32_FLOPS)
    t_bytes = nbytes[name] / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_flash(torch) -> dict:
    """Phase 3b: each of B1-B3 against its plain version on the card,
    both dtypes, at every shape of FLASH_SHAPES (out, lse and the three
    gradients through autograd with a random dO and nonzero dLSE, then
    B2 and B3 alone), each tensor within FLASH_TOL, and two wrong
    attentions outside it; then times at the main path's shape and the
    fwd+bwd kernel vs plain data for FLASH_MIN_LEN. Every reading is
    printed before a failure is raised."""
    import torch.nn.functional as F

    from ddp_tpu_torch.ops import flash as fl

    from ddp_tpu_torch.ops import _build

    lib = fl._lib()
    log("[flash] shared memory a block at D 128, bytes: " + ", ".join(
        f"{name} {dname} {lib.flash_attn_smem_bytes(i, int(dname == 'bf16'), 128)}"
        for i, name in enumerate(FLASH_NAMES) for dname in ("bf16", "fp32")))
    for name, r in ptxas_rows(_build):
        if name.startswith("dq_"):
            log(f"[flash] B2 {_ptxas_text(name, r)}")
    results, failures = {}, {}
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        tol = FLASH_TOL[dname]
        errs = {n: 0.0 for n in FLASH_NAMES}
        failed = []
        for i, (label, B, T, S, H, D, causal) in enumerate(FLASH_SHAPES):
            q, k, v, dout, dlse = _flash_inputs(torch, B, T, S, H, D, dtype,
                                                seed=i)
            got = _with_grads(
                torch, lambda *a: fl.flash_attention_with_lse(*a, causal),
                q, k, v, dout, dlse)
            want = _with_grads(
                torch, lambda *a: fl.attention_with_lse_reference(*a, causal),
                q.float(), k.float(), v.float(), dout.float(), dlse)
            # B2 and B3 alone, on the kernel forward's own out and lse.
            out, lse = got["out"], got["lse"]
            delta = fl.backward_delta(out, dout, dlse)
            dq2 = fl.flash_dq(q, k, v, dout, lse, delta, causal)
            dk2, dv2 = fl.flash_dkv(q, k, v, dout, lse, delta, causal)
            p_dq = fl.flash_dq_reference(q.float(), k.float(), v.float(),
                                         dout.float(), lse, delta, causal)
            p_dk, p_dv = fl.flash_dkv_reference(
                q.float(), k.float(), v.float(), dout.float(), lse, delta,
                causal)
            torch.cuda.synchronize()
            checks = {
                "flash_attn_fwd": [("out", out, want["out"]),
                                   ("lse", lse, want["lse"])],
                "flash_attn_dq": [("dq", got["dq"], want["dq"]),
                                  ("dq alone", dq2, p_dq)],
                "flash_attn_dkv": [("dk", got["dk"], want["dk"]),
                                   ("dv", got["dv"], want["dv"]),
                                   ("dk alone", dk2, p_dk),
                                   ("dv alone", dv2, p_dv)],
            }
            log(f"[flash] {dname} {label} B={B} T={T} S={S} H={H} D={D} "
                f"(rel <= {tol['rel']:g}, |d| <= {tol['atol']:g} + "
                f"{tol['rtol']:g}·|want|):")
            for name, items in checks.items():
                for what, a, b in items:
                    ok, text = _compare(torch, a, b, tol)
                    log(f"[flash]   {what}: {text}"
                        + ("" if ok else "  <-- FAILS"))
                    if not ok:
                        failed.append(f"{label} {what}")
                    errs[name] = max(errs[name], float(
                        (a.float() - b.float()).abs().nan_to_num(0.0).max()))
            del q, k, v, dout, dlse, got, want, out, lse, delta
            del dq2, dk2, dv2, p_dq, p_dk, p_dv
            torch.cuda.empty_cache()
        failed += _reject_wrong_kernels(torch, fl, dtype, dname)
        failed += _check_deterministic(torch, fl, dtype, dname)
        if failed:
            failures[dname] = failed
        results[dname] = _time_flash(torch, F, fl, dtype, dname, errs)
    _flash_min_len_data(torch, fl)
    if failures:
        raise AssertionError(f"flash kernels vs plain: {failures}")
    return results


TRAIN_SHAPE = (8, 2048, 2048, 8, 128, True)  # B, T, S, H, D, causal


def _kernel_calls(fl, q, k, v, dout, lse, delta, causal) -> dict:
    """One call of each of B1-B3 on these inputs, by name."""
    return {
        "flash_attn_fwd": lambda: fl.flash_forward(q, k, v, causal),
        "flash_attn_dq": lambda: fl.flash_dq(q, k, v, dout, lse, delta, causal),
        "flash_attn_dkv": lambda: fl.flash_dkv(q, k, v, dout, lse, delta,
                                               causal),
    }


def time_flash_kernels(torch, dtype) -> dict:
    """B1-B3 in ``dtype`` at the training shape, kernel times only
    (medians of 5 x 10 calls) → {name: ms}: the reading that compares two
    trees in one call (``--time-flash [--root DIR]``)."""
    from ddp_tpu_torch.ops import flash as fl

    B, T, S, H, D, causal = TRAIN_SHAPE
    q, k, v, dout, _ = _flash_inputs(torch, B, T, S, H, D, dtype, seed=99)
    out, lse = fl.flash_forward(q, k, v, causal)
    delta = fl.backward_delta(out, dout)
    calls = _kernel_calls(fl, q, k, v, dout, lse, delta, causal)
    return {name: _median_ms(torch, fn, n=10, reps=5)
            for name, fn in calls.items()}


def _time_flash(torch, F, fl, dtype, dname, errs) -> dict:
    """Kernel, plain version and SDPA times at the main path's shape
    (the training step's: B 8, T = S 2048, H 8, D 128, causal)."""
    B, T, S, H, D, causal = TRAIN_SHAPE
    q, k, v, dout, _ = _flash_inputs(torch, B, T, S, H, D, dtype, seed=99)
    out, lse = fl.flash_forward(q, k, v, causal)
    delta = fl.backward_delta(out, dout)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    n, reps = (10, 5) if dname == "bf16" else (5, 3)
    kernel = _kernel_calls(fl, q, k, v, dout, lse, delta, causal)
    plain = {
        "flash_attn_fwd": lambda: fl.attention_with_lse_reference(
            qf, kf, vf, causal),
        "flash_attn_dq": lambda: fl.flash_dq_reference(
            qf, kf, vf, df, lse, delta, causal),
        "flash_attn_dkv": lambda: fl.flash_dkv_reference(
            qf, kf, vf, df, lse, delta, causal),
    }
    # The yardstick: SDPA forward, and its backward (dq, dk and dv in one
    # call), on the same tensors in [B, H, T, D]; timed only.
    qs, ks, vs = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    sdpa_fwd_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), n=n, reps=reps)
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    do_s = dout.transpose(1, 2)
    sdpa_bwd_ms = _median_ms(torch, lambda: torch.autograd.grad(
        o_s, (qs, ks, vs), do_s, retain_graph=True), n=n, reps=reps)
    if dname == "fp32":
        _log_sdpa_numerics(torch, F, fl, qs, ks, vs, qf, kf, vf)
    pairs, nbytes = _flash_counts(B, T, S, H, D, causal, q.element_size())
    res = {}
    for name in FLASH_NAMES:
        ms = _median_ms(torch, kernel[name], n=n, reps=reps)
        plain_ms = _median_ms(torch, plain[name], n=2, reps=3)
        bound_ms, bound_by = _flash_bound(name, pairs, nbytes, D, dname)
        library_ms = sdpa_fwd_ms if name == "flash_attn_fwd" else None
        log(f"[flash] {name} {dname} B={B} T=S={T} H={H} D={D} causal: "
            f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"sdpa {'fwd' if library_ms else 'bwd (dq+dk+dv)'} "
            f"{(library_ms or sdpa_bwd_ms) * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.1f} us ({bound_by}), "
            f"{bound_ms / ms:.3f} of the bound")
        res[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, sdpa_bwd_ms=sdpa_bwd_ms)
    del q, k, v, dout, out, lse, qs, ks, vs, o_s
    torch.cuda.empty_cache()
    return res


def _log_sdpa_numerics(torch, F, fl, qs, ks, vs, qf, kf, vf) -> None:
    """The fp32 yardstick's numerics: the device kernels one SDPA forward
    and backward launch (torch.profiler), and its out against the plain
    version's at the training shape, in the phase's own measure."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(o, (qs, ks, vs), torch.ones_like(o))
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "self_device_time_total", 0) > 0})
    want = fl.attention_with_lse_reference(qf, kf, vf, True)[0]
    _, text = _compare(torch, o.detach().transpose(1, 2), want,
                       FLASH_TOL["fp32"])
    log(f"[flash] sdpa fp32 (allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}) kernels: "
        + "; ".join(n[:120] for n in names))
    log(f"[flash] sdpa fp32 forward vs plain at the training shape: {text}")
    del o, want
    torch.cuda.empty_cache()


def _flash_min_len_data(torch, fl) -> None:
    """fwd+bwd time, kernel vs plain (and the dense bf16 path of
    ops.attention), at B 8, H 8, D 128, causal, bf16, per length: the
    data for re-measuring FLASH_MIN_LEN on this card."""
    from ddp_tpu_torch.ops.attention import dot_product_attention

    for T in (256, 512, 1024, 2048):
        q, k, v, dout, _ = _flash_inputs(torch, 8, T, T, 8, 128,
                                         torch.bfloat16, seed=T)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def run(fn):
            out = fn(*leaves)
            torch.autograd.grad(out, leaves, dout)

        ms = {
            "kernel": _median_ms(torch, lambda: run(
                lambda *a: fl.flash_attention(*a, True)), n=5, reps=3),
            "plain": _median_ms(torch, lambda: run(
                lambda *a: fl.attention_with_lse_reference(*a, True)[0]),
                n=2, reps=3),
            "dense bf16": _median_ms(torch, lambda: run(
                lambda *a: dot_product_attention(*a, causal=True)),
                n=2, reps=3),
        }
        log(f"[flash] FLASH_MIN_LEN data, T={T} bf16 causal fwd+bwd: "
            + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in ms.items()))
        del q, k, v, dout, leaves
        torch.cuda.empty_cache()


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


# ---- phase 5: the training slice end to end ----------------------------

# The repo's full-width training configuration (bench.py run_lm_bench:
# vocab 8192, d_model 1024, depth 8, 8 heads, T 2048, batch 8, Adam 3e-4,
# bf16 compute): 48 sequences = 6 steps per epoch, an eval of 8.
TRAIN_ARGS = [
    "--model", "causal_lm", "--dataset", "synthetic_seq",
    "--synthetic_size", "48", "--seq_len", "2048", "--vocab_size", "8192",
    "--model_dim", "1024", "--model_depth", "8", "--num_heads", "8",
    "--batch_size", "8", "--epochs", "2", "--optimizer", "adam",
    "--lr", "3e-4", "--compute_dtype", "bfloat16",
]
# The fp32 variants on the same path: depth 2, one epoch.
TRAIN_FP32_ARGS = TRAIN_ARGS[:-1] + ["float32"]
TRAIN_FP32_ARGS[TRAIN_FP32_ARGS.index("--model_depth") + 1] = "2"
TRAIN_FP32_ARGS[TRAIN_FP32_ARGS.index("--epochs") + 1] = "1"
# One step through the kernels vs through the plain attention, from the
# same weights and batch: relative error of the loss, of the whole
# gradient, and of each parameter's gradient, the worst over every
# block's attn.qkv and attn.proj apart. bf16: the kernel rounds P and dS
# to bf16 for their products, the plain version does not; fp32: summation
# order only.
STEP_TOL = {"bf16": dict(loss=1e-5, grad=1e-2, leaf=2e-2, attn=2e-2),
            "fp32": dict(loss=1e-5, grad=1e-4, leaf=1e-4, attn=1e-4)}


def _lm_flops_per_token(spec) -> float:
    """Training flops per token, bench.py run_lm_bench's estimate: 6·N
    (tied embedding counted once) + causal attention 3.5 × 2 matmuls ×
    T/2 keys × d × depth."""
    d, T = spec.d_model, spec.total_len
    n_params = spec.depth * 12 * d * d + spec.vocab_size * d
    return 6 * n_params + 3.5 * 2 * 2 * (T / 2) * d * spec.depth


def _zero(counts: dict) -> None:
    for k in counts:
        counts[k] = 0


def _step_grads(torch, trainer, toks, block_fn):
    """One Adam step from the trainer's current weights on ``toks`` →
    (loss, {parameter name: gradient})."""
    from ddp_tpu_torch.models.lm import CausalLM, make_lm_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    state = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    model = CausalLM.from_state(trainer.spec, state, trainer.device,
                                trainable=True)
    opt = make_optimizer(model.parameters(), "adam", lr=3e-4)
    step = make_lm_train_step(model, opt, compute_dtype=trainer.compute_dtype,
                              block_fn=block_fn)
    m = step(toks)
    grads = {n: p.grad for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return float(m.loss), grads


def _grad_errors(got, want) -> dict:
    """Relative errors: of the loss, of the whole gradient, the worst
    parameter (name, error) and the worst attn.qkv/attn.proj one."""
    def rel(n):
        return float((got[1][n] - want[1][n]).norm()
                     / want[1][n].norm().clamp_min(1e-30))

    per = {n: rel(n) for n in want[1]}
    diff2 = sum(float((got[1][n] - want[1][n]).norm()) ** 2 for n in want[1])
    norm2 = sum(float(want[1][n].norm()) ** 2 for n in want[1])
    attn = {n: e for n, e in per.items() if ".attn." in n}
    return dict(loss=abs(got[0] - want[0]) / abs(want[0]),
                grad=(diff2 / norm2) ** 0.5,
                leaf=max(per.items(), key=lambda x: x[1]),
                attn=max(attn.items(), key=lambda x: x[1]))


def _errors_text(e) -> str:
    return (f"loss rel {e['loss']:.2e}, gradient rel {e['grad']:.2e}, worst "
            f"leaf {e['leaf'][1]:.2e} ({e['leaf'][0]}), worst attention leaf "
            f"{e['attn'][1]:.2e} ({e['attn'][0]})")


def _within(e, tol) -> bool:
    return (e["loss"] <= tol["loss"] and e["grad"] <= tol["grad"]
            and e["leaf"][1] <= tol["leaf"] and e["attn"][1] <= tol["attn"])


def compare_step(torch, trainer, dname, *, batch=2) -> None:
    """One Adam step from the trainer's current weights on its first
    ``batch`` sequences, through the kernels and through the plain
    attention (which must launch nothing), held to STEP_TOL. Then a
    negative control that the same limits must reject: the plain
    attention with the dK of one 64-key tile (keys 512-575) dropped, as a
    B3 that skipped a tile would give. In bf16 one more reading, for
    information only: an attention computed in bf16 throughout (S,
    softmax and P·V) lands next to the kernel's own bf16 rounding here,
    so no limit can tell the two apart."""
    from ddp_tpu_torch.ops import flash as fl

    class DropKeyGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, k):
            return k.view_as(k)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[:, 512:576] = 0
            return g

    def dropped_dk(q, k, v, causal):
        return fl.attention_with_lse_reference(q, DropKeyGrad.apply(k), v,
                                               causal)

    def low_precision(q, k, v, causal):
        T = q.shape[1]
        s = torch.einsum("bthd,bshd->bhts", q, k) * q.shape[-1] ** -0.5
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.bfloat16().masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s.float(), dim=-1).transpose(1, 2)
        out = torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1),
                           v.bfloat16())
        return out.to(q.dtype), lse

    toks = trainer.tokens[:batch]
    tol = STEP_TOL[dname]
    kernel = _step_grads(torch, trainer, toks, None)
    _zero(fl.flash_attention.launches)
    plain = _step_grads(torch, trainer, toks, fl.attention_with_lse_reference)
    e = _grad_errors(kernel, plain)
    log(f"[train] {dname} one step, kernel vs plain attention (batch "
        f"{batch}): loss {kernel[0]:.6f} vs {plain[0]:.6f}; {_errors_text(e)} "
        f"(tolerances {tol})")
    failed = [] if _within(e, tol) else ["the kernel step disagrees"]
    del kernel
    e = _grad_errors(_step_grads(torch, trainer, toks, dropped_dk),
                     plain)
    log(f"[train] {dname} control, dK tile dropped vs plain: "
        f"{_errors_text(e)}")
    if _within(e, tol):
        failed.append("the check passes a B3 that drops a dK tile")
    if dname == "bf16":
        e = _grad_errors(_step_grads(torch, trainer, toks, low_precision),
                         plain)
        log(f"[train] bf16 reading, attention in bf16 throughout vs plain "
            f"(not a limit): {_errors_text(e)}")
    if any(fl.flash_attention.launches.values()):
        failed.append(f"the plain path launched {fl.flash_attention.launches}")
    del plain
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{dname} step: {failed}")


def profile_train_steps(torch, trainer, *, steps=3) -> None:
    """Device busy share of steady training steps from torch.profiler:
    summed CUDA kernel time over the wall time of ``steps`` steps, and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    B = trainer.config.batch_size
    batches = [trainer.tokens[i * B:(i + 1) * B] for i in range(steps + 1)]
    trainer.runner.step(batches[0])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.runner.step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    if not rows:
        log("[profile] torch.profiler reported no device time")
        return
    busy_us = sum(e.self_device_time_total for e in rows)
    flash_us = sum(e.self_device_time_total for e in rows
                   if any(sym in e.key for sym in FLASH_SYMBOLS))
    log(f"[profile] {steps} training steps (bf16, batch {B}, T "
        f"{trainer.config.seq_len}): wall {wall * 1e3:.2f} ms, device kernel "
        f"time {busy_us / 1e3:.2f} ms, busy share {busy_us / 1e6 / wall:.3f}, "
        f"flash kernels B1-B3 {flash_us / busy_us:.3f} of device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:9.2f} "
            f"ms/step x{e.count // steps:<4d} {e.key[:90]}")


def check_training(torch) -> dict:
    """Phase 5: ``python -m ddp_tpu_torch.train``'s own main() at the
    full width (bf16), then its fp32 variant at depth 2 → the launch
    counts of each run, by counter name."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train.trainer import main as train_main

    launches = fl.flash_attention.launches
    counted = {}
    for args, dname in ((TRAIN_ARGS, "bf16"), (TRAIN_FP32_ARGS, "fp32")):
        log(f"[train] python -m ddp_tpu_torch.train {' '.join(args)}")
        _zero(launches)
        fl.flash_attention.plain_routed = 0
        trainer = train_main(args)
        torch.cuda.synchronize()
        got = dict(launches)
        if fl.flash_attention.plain_routed:
            raise AssertionError(
                f"{dname}: {fl.flash_attention.plain_routed} blocks routed to "
                "the plain block on the main training path")
        spec, cfg = trainer.spec, trainer.config
        steps = trainer.runner.steps_per_epoch * cfg.epochs
        n_params = sum(p.numel() for p in trainer.model.parameters())
        want = spec.depth * steps
        log(f"[train] {dname}: {n_params / 1e6:.1f} M params, {steps} steps, "
            f"launches {got} (depth x steps = {want})")
        for name in FLASH_NAMES:
            if got[f"{name}_{dname}"] < want:
                raise AssertionError(f"{name} {dname}: {got} < {want}")
        other = "fp32" if dname == "bf16" else "bf16"
        if any(got[f"{n}_{other}"] for n in FLASH_NAMES):
            raise AssertionError(f"{other} kernels launched in a {dname} run")
        losses = [l for h in trainer.history for l in h["loss"]]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss in {losses}")
        flops = _lm_flops_per_token(spec)
        for h in trainer.history:
            p50_rate = cfg.batch_size * cfg.seq_len / h["step_p50_s"]
            mfu = (f", est. MFU {p50_rate * flops / H100_BF16_FLOPS:.3f}"
                   if dname == "bf16" else "")
            log(f"[train] {dname} epoch {h['epoch']}: mean loss "
                f"{h['train_loss']:.4f}, test loss {h['test_loss']:.4f}, "
                f"tokens/s {h['tokens_per_s']:.1f} (epoch wall), "
                f"{p50_rate:.1f} at the p50 step{mfu}, step p50 "
                f"{h['step_p50_s'] * 1e3:.2f} ms, steps "
                + ", ".join(f"{s * 1e3:.1f}" for s in h["step_seconds"]))
        if dname == "bf16":
            first, second = (h["train_loss"] for h in trainer.history)
            if not second < first:
                raise AssertionError(f"loss did not fall: {first} -> {second}")
            counted["bf16"] = {n: got[f"{n}_bf16"] for n in FLASH_NAMES}
            profile_train_steps(torch, trainer)
        else:
            counted["fp32"] = {n: got[f"{n}_fp32"] for n in FLASH_NAMES}
        compare_step(torch, trainer, dname)
        del trainer
        torch.cuda.empty_cache()
    return counted


# A head dim the flash kernels do not take (D 24 = 96 / 4): the causal LM
# trains through the plain block on the card (fault C1 of ROADMAP).
TRAIN_ROUTED_ARGS = [
    "--model", "causal_lm", "--dataset", "synthetic_seq",
    "--synthetic_size", "8", "--seq_len", "256", "--vocab_size", "256",
    "--model_dim", "96", "--model_depth", "2", "--num_heads", "4",
    "--batch_size", "4", "--epochs", "1", "--optimizer", "adam",
    "--lr", "3e-4", "--compute_dtype", "bfloat16",
]


def check_routed_training(torch) -> None:
    """Phase 5a: ``python -m ddp_tpu_torch.train`` at head dim 24, which
    B1-B3 do not take: every attention block must take the plain block on
    the card (counted > 0), launch no kernel, and give finite losses."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train.trainer import main as train_main

    log(f"[train] python -m ddp_tpu_torch.train {' '.join(TRAIN_ROUTED_ARGS)}")
    _zero(fl.flash_attention.launches)
    fl.flash_attention.plain_routed = 0
    trainer = train_main(TRAIN_ROUTED_ARGS)
    torch.cuda.synchronize()
    routed = fl.flash_attention.plain_routed
    launched = sum(fl.flash_attention.launches.values())
    losses = [l for h in trainer.history for l in h["loss"]]
    log(f"[train] head dim {trainer.spec.head_dim} on {trainer.device}: "
        f"{len(losses)} steps, losses {losses}, blocks routed to the plain "
        f"block {routed}, B1-B3 launches {launched}")
    if not (routed > 0 and launched == 0 and losses
            and all(np.isfinite(losses))):
        raise AssertionError("head dim 24 did not train through the plain "
                             "block")
    del trainer
    torch.cuda.empty_cache()


# ---- phase 6: the reference trainer's main path (SimpleCNN on MNIST) -----

# train.py --epochs 3 --batch_size 64 (the flow BASELINE.json measures),
# offline: the synthetic split at MNIST's full size (60,000 train, 10,000
# test), SimpleCNN at the reference's width (32, 64), world 1 over nccl.
# Momentum 0.9 gives the restored optimizer state buffers to compare.
CNN_ARGS = ["--model", "simple_cnn", "--synthetic_data", "--batch_size", "64",
            "--log_interval", "300", "--momentum", "0.9"]
CNN_DEVICE_ARGS: list[str] = []  # ["--device", "cpu"] when rehearsing
# The fast path against the step path, one epoch on the same plan, with
# deterministic cuDNN: the same step on the same batches (host gather vs
# device gather of the same bytes), so the parameters should agree bit for
# bit; the limit leaves room for one rounding.
FAST_ATOL = 1e-6
# One step on the card (fp32, TF32 off) vs the same step on the CPU:
# summation order only.
CNN_STEP_TOL = dict(loss=1e-5, grad=1e-4, leaf=1e-4)
# Two gloo ranks on the card (per-rank batch 32) vs world 1 (batch 64),
# SPAWN_SIZE synthetic images (200 steps): each step's union of the two
# strided shards is the world-1 batch, so only summation order (the
# bucket sum, cuDNN at batch 32 vs 64) parts them; it compounds over the
# steps.
SPAWN_SIZE, SPAWN_ATOL = 12800, 1e-4
BENCH_BATCH = 16384  # bench.py run_bench's global batch (bench.py:88-92)
# Training flops per image, SimpleCNN at (32, 64): forward
# 2·784·(1·32 + 32·64)·9 + 2·50176·10, times 3 for the backward.
CNN_TRAIN_FLOPS = 3 * (2 * 784 * (32 + 32 * 64) * 9 + 2 * 50176 * 10)


class _Tee:
    """stdout to the terminal and to a buffer (the trainer's log lines are
    part of what phase 6 checks)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _train(args: list[str]):
    """``python -m ddp_tpu_torch.train``'s own main() in-process →
    (trainer or None, the lines it printed)."""
    import contextlib

    from ddp_tpu_torch.train.trainer import main as train_main

    argv = CNN_ARGS + CNN_DEVICE_ARGS + args
    log(f"[cnn] python -m ddp_tpu_torch.train {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        trainer = train_main(argv)
    return trainer, tee.text()


def _cnn_state_errors(torch, trainer, blob) -> list[str]:
    """Where ``trainer``'s live state differs from a checkpoint dict (bit
    for bit): parameters, step count, optimizer count and buffers."""
    bad = [k for k, v in trainer.state.model.state_dict().items()
           if not torch.equal(v.cpu(), blob["params"][k])]
    opt = trainer.state.optimizer.state_dict()
    if trainer.state.step != blob["step"]:
        bad.append(f"step {trainer.state.step} != {blob['step']}")
    if opt["count"] != blob["opt_state"]["count"]:
        bad.append("optimizer count")
    bad += [f"momentum buffer {i}" for i, (a, b) in enumerate(
        zip(opt["trace"], blob["opt_state"]["trace"])) if not torch.equal(a, b)]
    return bad


def _epoch_line(h, label) -> str:
    return (f"[cnn] {label} epoch {h['epoch']}: mean loss "
            f"{h['train_loss']:.4f}, train accuracy {h['train_accuracy']:.4f}, "
            f"test accuracy {h.get('test_accuracy', float('nan')):.4f}, "
            f"{h['images_per_s_per_card']:.1f} images/s per card (epoch wall), "
            f"step p50 {h['step_p50_s'] * 1e3:.3f} ms, "
            f"{len(h['loss'])} steps")


def check_cnn_main_path(torch, tmp) -> dict:
    """Phase 6a: train 3 epochs, resume, quarantine a corrupt epoch →
    the step path's readings."""
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    ckdir = f"{tmp}/main"
    failed = []
    trainer, out = _train(["--epochs", "3", "--checkpoint_dir", ckdir])
    for h in trainer.history:
        log(_epoch_line(h, "step path, batch 64,"))
    losses = [h["train_loss"] for h in trainer.history]
    mgr = CheckpointManager(ckdir)
    verified = {e: mgr.verify_epoch(e) for e in mgr.all_epochs()}
    log(f"[cnn] epochs saved {sorted(verified)}, manifest problems "
        f"{verified}, final line {out.strip().splitlines()[-1]!r}")
    if not (len(losses) == 3 and all(np.isfinite(l) for h in trainer.history
                                      for l in h["loss"])
            and losses[2] < losses[0]):
        failed.append(f"losses not finite and falling: {losses}")
    if sorted(verified) != [0, 1, 2] or any(v != [] for v in verified.values()):
        failed.append("epoch_0..2 missing or unverified")
    if "final_accuracy=" not in out:
        failed.append("no final_accuracy= line")
    readings = {"step_64": trainer.history[-1], "main_trainer": trainer}

    # The same run again: nothing left to train; the restored state must
    # be epoch 2's, bit for bit.
    again, out = _train(["--epochs", "3", "--checkpoint_dir", ckdir])
    bad = _cnn_state_errors(torch, again, mgr.read(2))
    log(f"[cnn] re-run at --epochs 3: epochs trained {len(again.history)}, "
        f"state vs epoch_2 differs in {bad or 'nothing'}")
    if "Resumed from checkpoint epoch 2" not in out or again.history or bad:
        failed.append("the restore is not epoch 2's state")
    del again
    resumed, out = _train(["--epochs", "4", "--checkpoint_dir", ckdir])
    log(f"[cnn] --epochs 4: epochs trained "
        f"{[h['epoch'] for h in resumed.history]}")
    if ("Resumed from checkpoint epoch 2" not in out
            or [h["epoch"] for h in resumed.history] != [3]):
        failed.append("--epochs 4 did not resume at epoch 3 for one epoch")
    del resumed

    # One flipped byte in epoch 3's state file: discovery quarantines it and
    # resumes from epoch 2.
    path = f"{ckdir}/epoch_3/state.pt"
    with open(path, "r+b") as f:
        f.seek(-100, 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    healed, out = _train(["--epochs", "5", "--checkpoint_dir", ckdir])
    import os

    quarantined = os.path.isdir(f"{ckdir}/quarantine.epoch-3")
    log(f"[cnn] --epochs 5 after a flipped byte in epoch_3: quarantine.epoch-3 "
        f"{'present' if quarantined else 'absent'}, epochs trained "
        f"{[h['epoch'] for h in healed.history]}")
    if not (quarantined and "Resumed from checkpoint epoch 2" in out
            and [h["epoch"] for h in healed.history] == [3, 4]):
        failed.append("the corrupt epoch was not quarantined with a fallback "
                      "to epoch 2")
    del healed
    if failed:
        raise AssertionError(f"phase 6a: {failed}")
    return readings


def check_cnn_fast_path(torch, tmp) -> None:
    """Phase 6b: one epoch through the fast path against one through the
    step path, from the same seeded weights on the same plan."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step, _ = _train(["--epochs", "1", "--checkpoint_dir", f"{tmp}/s"])
        fast, _ = _train(["--epochs", "1", "--fast_epoch", "--checkpoint_dir",
                          f"{tmp}/f"])
    finally:
        torch.backends.cudnn.deterministic = prev
    err = max(float((a - b).abs().max()) for a, b in zip(
        step.state.model.state_dict().values(),
        fast.state.model.state_dict().values()))
    log(f"[cnn] fast vs step path after one epoch: max |param diff| {err:.3e} "
        f"(limit {FAST_ATOL}); losses equal at every step: "
        f"{step.history[-1]['loss'] == fast.history[-1]['loss']}")
    if not err <= FAST_ATOL:
        raise AssertionError(f"phase 6b: fast path parts from the step path "
                             f"by {err}")


def _cnn_step(torch, state_np, x, y, device, *, world=1, rank=0, reduce=None):
    """One SGD step of SimpleCNN from ``state_np`` on this rank's rows of
    (x, y) → (loss, {name: averaged gradient}, {name: updated param})."""
    from ddp_tpu_torch.models.cnn import SimpleCNN
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    model = SimpleCNN.from_state(state_np, device)
    state = TrainState(0, model, make_optimizer(model.parameters(), "sgd",
                                                lr=0.01))
    step = make_train_step(state, world=world,
                           reduce=reduce or (lambda t: t))
    local = len(y) // world
    rows = slice(rank * local, (rank + 1) * local)
    m = step(torch.from_numpy(x[rows]).to(device),
             torch.from_numpy(y[rows]).to(device))
    return (float(m.loss),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def _cnn_step_errors(got, want) -> dict:
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    g, w = got[1], want[1]
    diff2 = sum(float((g[n] - w[n]).norm()) ** 2 for n in w)
    norm2 = sum(float(w[n].norm()) ** 2 for n in w)
    return dict(loss=abs(got[0] - want[0]) / abs(want[0]),
                grad=(diff2 / norm2) ** 0.5,
                leaf=max(((n, rel(g[n], w[n])) for n in w), key=lambda x: x[1]),
                param=max(((n, rel(got[2][n], want[2][n])) for n in w),
                          key=lambda x: x[1]))


def _cnn_within(e) -> bool:
    t = CNN_STEP_TOL
    return (e["loss"] <= t["loss"] and e["grad"] <= t["grad"]
            and e["leaf"][1] <= t["leaf"] and e["param"][1] <= t["leaf"])


def _cnn_errors_text(e) -> str:
    return (f"loss rel {e['loss']:.2e}, gradient rel {e['grad']:.2e}, worst "
            f"leaf gradient {e['leaf'][1]:.2e} ({e['leaf'][0]}), worst "
            f"updated parameter {e['param'][1]:.2e} ({e['param'][0]})")


def check_cnn_step(torch, device="cuda") -> None:
    """Phase 6c: one step on the card (fp32, TF32 off) against the same
    step on the CPU, from the same seeded full-width weights and batch of
    64; the same at a forced world of 2 (two replicas, half the batch
    each, the bucket summed over both); and the negative control, a world
    2 whose average divides by the world twice, which must fail."""
    from ddp_tpu_torch.data.mnist import synthetic
    from ddp_tpu_torch.models.cnn import init_cnn_state

    state_np = init_cnn_state(seed=0)
    data = synthetic(64, seed=3)
    x, y = data.images, data.labels
    want = _cnn_step(torch, state_np, x, y, "cpu")
    got = _cnn_step(torch, state_np, x, y, device)
    e = _cnn_errors_text(_cnn_step_errors(got, want))
    log(f"[cnn] one step, card vs CPU (fp32, TF32 off, batch 64): loss "
        f"{got[0]:.6f} vs {want[0]:.6f}; {e} (limits {CNN_STEP_TOL})")
    failed = [] if _cnn_within(_cnn_step_errors(got, want)) else [
        "the card's step disagrees with the CPU's"]
    from ddp_tpu_torch.runtime.dist import ThreadWorld

    for extra, label in ((1, "world 2"), (2, "control, world 2 averaged twice")):
        tw = ThreadWorld(2)

        def rank_step(r):
            total = tw.reduce(r)
            return _cnn_step(torch, state_np, x, y, device, world=2, rank=r,
                             reduce=lambda t: total(t).div_(extra))

        two = tw.run(rank_step)[0]
        e = _cnn_step_errors(two, want)
        log(f"[cnn] {label} on the card vs the CPU's world 1: "
            f"{_cnn_errors_text(e)}")
        if extra == 1 and not _cnn_within(e):
            failed.append("the world-2 step disagrees")
        if extra == 2 and _cnn_within(e):
            failed.append("the check passes a gradient divided by the world "
                          "twice")
    if failed:
        raise AssertionError(f"phase 6c: {failed}")


def check_cnn_real_digits(repo: str) -> float:
    """Phase 6d: the reference recipe (SGD 0.01, batch 32, 3 epochs;
    bench.py:3301-3330) on the vendored uci_digits → test accuracy (a
    reading)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        trainer, _ = _train([
            "--dataset", "uci_digits", "--data_root", f"{repo}/data",
            "--batch_size", "32", "--momentum", "0", "--epochs", "3",
            "--checkpoint_dir", tmp, "--log_interval", "1000"])
    acc = trainer.summary["final_accuracy"]
    log(f"[cnn] uci_digits (1,437 train / 360 test), reference recipe, 3 "
        f"epochs: test accuracy {acc:.4f} (a reading, not a limit)")
    return acc


def check_cnn_two_ranks(torch, tmp) -> None:
    """Phase 6e: ``--spawn 2 --backend gloo``, both ranks on the one card
    at per-rank batch 32, against world 1 at batch 64 on the same plan."""
    base = ["--epochs", "1", "--synthetic_size", str(SPAWN_SIZE),
            "--momentum", "0"]
    _train(base + ["--spawn", "2", "--backend", "gloo", "--batch_size", "32",
                   "--checkpoint_dir", f"{tmp}/w2"])
    _train(base + ["--checkpoint_dir", f"{tmp}/w1"])
    a = torch.load(f"{tmp}/w1/epoch_0/state.pt", weights_only=True)
    b = torch.load(f"{tmp}/w2/epoch_0/state.pt", weights_only=True)
    err = max(float((a["params"][k] - b["params"][k]).abs().max())
              for k in a["params"])
    log(f"[cnn] --spawn 2 over gloo on one card (batch 32 each) vs world 1 "
        f"(batch 64), {a['step']} / {b['step']} steps: max |param diff| "
        f"{err:.3e} (limit {SPAWN_ATOL})")
    if a["step"] != b["step"] or not err <= SPAWN_ATOL:
        raise AssertionError("phase 6e: two ranks part from world 1")


def profile_cnn_epoch(torch, trainer, label) -> float:
    """Busy share of one more epoch of ``trainer`` under torch.profiler:
    summed CUDA kernel time over the wall time (the profiler's own host
    cost included)."""
    from torch.profiler import ProfilerActivity, profile

    from ddp_tpu_torch.runtime import dist
    from ddp_tpu_torch.train.fast import run_steps

    epoch = trainer.config.epochs + 7
    dist.setup(device=str(trainer.device))  # the step all-reduces
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if trainer.fast_runner is not None:
                trainer.fast_runner(epoch)
            else:
                run_steps(trainer.train_step, trainer.loader.epoch(epoch),
                          on_gpu=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        dist.cleanup()
    events = prof.key_averages()
    rows = [e for e in events
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    steps = trainer.steps_per_epoch
    log(f"[profile] {label}: {steps} steps, wall {wall * 1e3:.2f} ms, device "
        f"kernel time {busy * 1e3:.2f} ms, busy share {busy / wall:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / steps:9.2f} us/step "
            f"x{e.count / steps:<5.1f} {e.key[:90]}")
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        log(f"[profile]   host {e.self_cpu_time_total / steps:9.2f} us/step "
            f"x{e.count / steps:<5.1f} {e.key[:90]}")
    return busy / wall


def time_cnn(torch, readings, tmp, card) -> dict:
    """images/s per card, step p50 and busy share: the step path at batch
    64 (6a's last epoch), the fast path at batch 64, then both paths at
    global batch 16384 (fp32) and the fast path there in bf16, each after
    a warm-up epoch, with cuDNN's default (non-deterministic) choices."""
    out = {}
    runs = [("step path, batch 64", readings["main_trainer"])]
    for label, batch, flags in (
            ("fast path, batch 64", 64, ["--fast_epoch"]),
            ("step path, batch 16384", BENCH_BATCH, []),
            ("fast path, batch 16384", BENCH_BATCH, ["--fast_epoch"]),
            ("fast path, batch 16384, bf16", BENCH_BATCH,
             ["--fast_epoch", "--compute_dtype", "bfloat16"])):
        trainer, _ = _train(["--batch_size", str(batch), "--epochs", "2",
                             "--eval_every", "0", "--checkpoint_dir",
                             f"{tmp}/b{len(runs)}"] + flags)
        runs.append((label, trainer))
    for label, trainer in runs:
        h = trainer.history[-1]
        busy = profile_cnn_epoch(torch, trainer, label)
        rate = trainer.global_batch_size / h["step_p50_s"]
        peak = H100_BF16_FLOPS if "bf16" in label else H100_FP32_FLOPS
        out[label] = dict(images_per_s=h["images_per_s_per_card"],
                          step_p50_ms=h["step_p50_s"] * 1e3, busy=busy)
        log(f"[time] {label} ({card}): {h['images_per_s_per_card']:.1f} "
            f"images/s per card over the epoch, {rate:.1f} at the p50 step "
            f"{h['step_p50_s'] * 1e3:.3f} ms, est. "
            f"{rate * CNN_TRAIN_FLOPS / 1e12:.2f} TFLOP/s "
            f"({rate * CNN_TRAIN_FLOPS / peak:.3f} of the "
            f"{'bf16' if 'bf16' in label else 'fp32'} peak), busy share "
            f"{busy:.3f} (under the profiler)")
    return out


def check_cnn(torch, card) -> dict:
    """Phase 6: the reference trainer's main path, every reading printed
    before any raise."""
    import os
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        readings = check_cnn_main_path(torch, tmp)
        check_cnn_fast_path(torch, tmp)
        check_cnn_step(torch)
        readings["uci_digits_accuracy"] = check_cnn_real_digits(repo)
        check_cnn_two_ranks(torch, tmp)
        readings["timing"] = time_cnn(torch, readings, tmp, card)
    return readings


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
        dec.flash_decode_attention.plain_routed = 0
        _, engine = serve_run(torch, model, prompts, kv_dtype=kv_dtype)
        got = dict(launches)
        routed = dec.flash_decode_attention.plain_routed
        want = engine.decode_steps * spec.depth
        log(f"[serve] kv={kv_dtype} launches {got} (decode steps x depth "
            f"= {want}), routed to the plain version by shape: {routed}")
        if engine.decode_attn != "flash" or got[name] < want or want == 0:
            raise AssertionError(f"{name}: {got[name]} launches < {want}")
        if routed:
            raise AssertionError(f"the serving path routed {routed} calls "
                                 "to the plain version")
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


def ptxas_rows(_build) -> list[tuple[str, dict]]:
    """ptxas's report of each flash-attention kernel → [(name with its
    head-dim tile, e.g. "dq_sm90<128>", report row)]."""
    rows = []
    for r in _build.ptxas_report("flash_attn.cu"):
        name = next((sym for sym in FLASH_SYMBOLS if sym in r["kernel"]),
                    r["kernel"])
        name += ("<128>" if "ILi128E" in r["kernel"] else "<64>"
                 if "ILi64E" in r["kernel"] else "")
        rows.append((name, r))
    return rows


def _ptxas_text(name, r) -> str:
    return (f"ptxas {name}: {r['registers']} registers at launch, "
            f"{r['smem']} bytes static smem, {r['stack']} bytes stack, "
            f"spill stores {r['spill_stores']} / loads {r['spill_loads']} "
            "bytes")


def log_ptxas(_build) -> None:
    """Phase 2: ptxas's report of each flash-attention kernel, and any
    line where ptxas serialised wgmma products or ignored setmaxnreg. A
    spill in a kernel of REGISTER_KERNELS would undo its register
    accumulators: it raises."""
    path = _build.log_path("flash_attn.cu")
    for line in (path.read_text() if path.is_file() else "").splitlines():
        if "Performance Loss" in line or "setmaxnreg ignored" in line:
            log(f"[build] ptxas: {line.strip()[:200]}")
    spills = []
    for name, r in ptxas_rows(_build):
        log(f"[build] {_ptxas_text(name, r)}")
        if (name.split("<")[0] in REGISTER_KERNELS
                and (r["spill_stores"] or r["spill_loads"])):
            spills.append(name)
    if spills:
        raise AssertionError(f"ptxas spilled in {spills}")


def decode_kernel_name(mangled: str) -> str:
    """A flash-decode kernel's mangled name → e.g. "split<int8,GT=4>" or
    "merge<GT=1>"."""
    m = re.search(r"flash_decode_(split|merge)I([fa]?)Li(\d+)E", mangled)
    if not m:
        return mangled[:60]
    kv = {"f": "fp32,", "a": "int8,", "": ""}[m.group(2)]
    return f"{m.group(1)}<{kv}GT={m.group(3)}>"


def log_decode_ptxas(_build) -> None:
    """Phase 2: ptxas's report of each flash-decode kernel (B4/B5 per
    query-head tile, and the merge). Its accumulators live in registers:
    a spill raises."""
    spills = []
    for r in _build.ptxas_report("flash_decode.cu"):
        name = decode_kernel_name(r["kernel"])
        log(f"[build] {_ptxas_text(name, r)}")
        if r["spill_stores"] or r["spill_loads"]:
            spills.append(name)
    if spills:
        raise AssertionError(f"ptxas spilled in {spills}")


def time_decode_main(argv) -> int:
    """``--time-decode [--root DIR]``: build flash_decode.cu of the
    package under DIR (default: this script's tree), print the card and
    one JSON line of B4/B5 times (µs) at full width, every lane at L-1,
    at L 256 and L 8192. Run it on two trees in turns (parent, change,
    change, parent) within one call to compare them on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--root" in argv:
        sys.path.insert(0, argv[argv.index("--root") + 1])
    from ddp_tpu_torch.ops import _build

    root = str(_build.CSRC.parents[2])
    _build.build(("flash_decode.cu",))
    us = {kv: {str(L): round(ms * 1e3, 2) for L, ms in row.items()}
          for kv, row in time_decode_kernels(torch).items()}
    log(card_line())
    print(json.dumps({"root": root, "us": us}), flush=True)
    return 0


def time_flash_main(argv) -> int:
    """``--time-flash [--root DIR] [--dtype bf16|fp32|both]``: build
    flash_attn.cu of the package under DIR (default: this script's tree),
    print the card and one JSON line of B1-B3 times (µs) at the training
    shape, per dtype (default both). Run it on two trees in turns
    (parent, change, change, parent) within one call to compare them on
    one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--root" in argv:
        sys.path.insert(0, argv[argv.index("--root") + 1])
    from ddp_tpu_torch.ops import _build

    which = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "both"
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    names = list(dtypes) if which == "both" else [which]
    root = str(_build.CSRC.parents[2])
    _build.build(("flash_attn.cu",))
    us = {}
    for dname in names:
        times = time_flash_kernels(torch, dtypes[dname])
        us[dname] = {n: round(ms * 1e3, 1) for n, ms in times.items()}
        torch.cuda.empty_cache()
    log(card_line())
    print(json.dumps({"root": root, "us": us}), flush=True)
    return 0


def main() -> int:
    if "--time-flash" in sys.argv:
        return time_flash_main(sys.argv)
    if "--time-decode" in sys.argv:
        return time_decode_main(sys.argv)
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
    log_ptxas(_build)
    log_decode_ptxas(_build)

    timings = check_kernels(torch)
    launches = check_serving(torch)
    flash = check_flash(torch)
    check_routed_training(torch)
    trained = check_training(torch)
    check_cnn(torch, card)

    replaces = {"flash_decode_fp32": "ddp_tpu/ops/decode.py:260",
                "flash_decode_int8": "ddp_tpu/ops/decode.py:270",
                "flash_attn_fwd": "ddp_tpu/ops/flash.py:88",
                "flash_attn_dq": "ddp_tpu/ops/flash.py:152",
                "flash_attn_dkv": "ddp_tpu/ops/flash.py:209"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": "ddp_tpu_torch/ops/csrc/flash_decode.cu",
         "replaces": replaces[name], "launches": launches[name],
         **timings[name]}
        for name in ("flash_decode_fp32", "flash_decode_int8")
    ]
    # B1-B3: the bf16 variant is the main path (the training run's
    # numbers); the fp32 variant's, from its own run, ride beside them.
    for name in FLASH_NAMES:
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ddp_tpu_torch/ops/csrc/flash_attn.cu",
            "replaces": replaces[name], "launches": trained["bf16"][name],
            **{k: flash["bf16"][name][k] for k in keys},
            "sdpa_bwd_ms": flash["bf16"][name]["sdpa_bwd_ms"],
            "variants": {"fp32": {
                "launches": trained["fp32"][name],
                **{k: flash["fp32"][name][k] for k in keys}}},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
