#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ddp_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-flash | --time-decode | --time-serve \
        [--root DIR]

The second form only times B1-B3, B4/B5 or the steady serving step of
the package under DIR (time_flash_main, time_decode_main,
time_serve_main). The first runs these phases, in
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
3c. The paged kernels B4p (fp32) and B5p (int8), which read K/V from a
   page pool through each lane's int32 page table, against the plain
   paged version (the gather, then the plain version; KERNEL_ATOL) at
   S 8, H 8, H_kv 8 and 2, Dh 128, page sizes 16 and 64 at L 256 and L
   8192, page size 8 at L 200, tables from a seeded permutation of the
   pool with lanes sharing pages and the scratch page 0 past each lane's
   pages; each result bitwise the fixed-lane kernel's over the gathered
   lanes, the same bits again, and the same bits with every pool row no
   band reads poisoned with NaN; a table with two live entries swapped
   must fail the check; a page size the kernel does not take is routed
   (counted) and raises on an explicit call. Then at L 256 and L 8192,
   page 16, every lane at L-1: the kernel, the JAX design (the gather,
   then B4/B5), the plain version and the library call (the gather,
   then SDPA with the band mask), beside the bound.
4. The serving slice end to end: the full-width causal LM (vocab 8192,
   d_model 1024, depth 8, 8 heads, total_len 256) from seeded random
   weights, ServeEngine(slots=8, prefill_len=128) behind LMServer on
   127.0.0.1, ten concurrent POST /generate requests (greedy and
   seeded sampling), once with fp32 and once with int8 KV. Each engine
   is warmed up first (warmup(): its step programs captured as CUDA
   graphs, as the serve CLI does); the launch counters are set to 0
   just after warmup and read just after the run; each run must launch
   its kernel exactly decode steps x depth times (all by graph
   replays). The
   greedy requests then run alone (a fixed schedule), through the
   kernel and through decode_attn="reference", and their streams must
   match (a divergence passes only where the top-2 logit gap at the
   first divergent token is below 1e-3). Last, torch.profiler reads
   the device busy share of steady decode steps.
4c. Paged serving end to end: ``python -m ddp_tpu_torch.serve``'s own
   main() at phase 4's full width with --page_size 16, serving over
   HTTP bench.py run_serve_prefix_bench's traffic (a seed request with
   a 96-token system prompt, then 24 concurrent requests of that prefix
   plus a 16-token tail, 32 new tokens each, greedy; prompts from
   PREFIX_SEED), in fp32 and int8 KV, then fp32 on a pool of 24 pages
   (LRU eviction and starved binds). main() warms up before it
   serves; counters set to 0 once its server answers and read after:
   the paged kernel launched exactly decode steps x depth times, no
   fixed-lane launch, nothing routed to a plain version. Every request completes; each stream equals the fixed-lane
   engine's on the same traffic (or parts only at a near tie, as in
   phase 4); prefix-hit rate >= 0.5 and peak effective-slots multiplier
   > 1.5 (bench.py's floors). It prints TTFT p50/p99 split hit against
   miss, decode tokens/s and step p50/p99, and the busy share of steady
   paged decode steps.
4d. Speculative decoding at phase 4's full width: a draft proposes γ 4
   tokens a lane through B4 on its own fp32 cache, the target verifies
   them in one step. With ``truncated_draft(model, 4)`` (the target's
   first 4 blocks, bench.py's zero-training draft), fp32 and int8
   target KV, phase 4's REQUESTS run in-process on a fixed schedule
   (SPEC_BUDGET: every prompt's chunk split is its own), and every
   greedy and seeded stream must equal the plain engine's or part only
   at a near tie (for a sampled token, of the scores its draw compares).
   The self-draft (all 8 blocks) on the greedy requests: every rejected
   position must be a near tie of the target. Paged (page 16) on phase
   4c's prefix traffic: streams equal the plain fixed-lane engine's.
   Counters set to 0 before each run and read after: flash_decode_fp32
   launched exactly rounds x γ x draft depth times, no B5, B4p or B5p
   launch, nothing routed to a plain version. A verify that counts the
   first mismatch as a match must fail the stream check. Then, on
   bench.py _variant's traffic (16 requests, prompts 8-64, 128 new
   tokens, seed 1), the plain engine, the truncated draft and the
   self-draft: tokens/s, step p50/p99, acceptance, tokens a target
   step, B4 launches a round and the steady round's split (γ draft
   steps against one verify, CUDA events); then the busy share of
   steady speculative rounds. In-process engines run their programs as
   CUDA graphs from a program's first (eager, counted) run on; the
   timed ones warm up first. The self-draft's rejection probe replaces
   generate's block sampler for the whole run, so the verify graph
   captures it.
4e. Serving observability at phase 4c's full width. (a) main() with
   --page_size 16 --reqtrace --slo OBS_SLO --trace_dir --flight_dir, fp32:
   phase 4c's prefix traffic plus a request with a valid trace context
   and one with a malformed one. Counters set to 0 before and read after:
   B4p launched exactly decode steps x depth, nothing else, nothing
   routed. Streams equal phase 4c's fixed-lane ones (near ties excepted);
   /metricsz (read once the SLO engine's 1 s evaluation throttle has
   passed) lints, agrees with /stats (steps, tokens, requests by
   status, prefix hits and misses, page gauges), has each objective's
   ddp_tpu_slo_* gauges and a build_info naming the card; every
   completion's /requestz?id=0x<trace id> timeline validates, its prefill
   tokens are the prompt minus the prefix hit, its decode tokens the new
   ones minus one, and it retires complete; the valid context is adopted
   (its id, its span as parent) and echoed, the malformed one counted
   orphaned and served; /statusz's trace loads as a traceEvents
   document; after SIGTERM the exported trace validates and holds every
   request, and the flight dump loads. (b) Phase 4d's truncated draft
   with request tracing on: the spec_round events of all timelines sum
   to the engine's drafted and accepted totals, B4 launched rounds x γ x
   draft depth. (c) The synchronizing calls of 32 steady decode steps of
   the fixed-lane fp32 engine (torch's sync debug mode "warn", plus
   wrappers for the waits it does not report): request tracing and an
   SLO engine add none; the tracer's measuring mode adds one a waiting
   span. (d) Not gated: steady decode step p50/p99 off / request
   tracing + SLO / plus the measuring mode, in turns, beside the card.
4f. The serving engine's compile contract at phase 4's full width: its
   step programs (the fused decode+sample step, a first-chunk and a
   continuation-chunk program per bucket width; with speculation the
   draft's chunk programs, the draft-decode and the verify step) as
   CUDA graphs. (a) warmup() on fixed-lane fp32 and int8, paged fp32
   and γ 4 speculative engines: JAX's counts, their sum the budget;
   capture seconds and the graphs' pool bytes. (g) the fp32 warmup runs
   under torch's sync debug mode "error". (b) phase 4's REQUESTS as one
   fixed schedule, eager (cuda_graphs=False) against graphs, fp32,
   int8, paged fp32 and paged int8: every stream, greedy and seeded,
   equal token for token; no program added by the traffic. (c) counters
   set to 0 after warmup equal Σ replays x the launches each program
   recorded at capture, and decode steps x depth. (e) γ 4 rounds
   through the draft_decode and spec_verify graphs: streams equal the
   plain graph engine's (near ties as 4d), B4 = rounds x γ x draft
   depth; tokens/s on bench.py _variant's traffic, plain and self-draft,
   graphs and eager, and the truncated draft. (f) the control: a weight
   rebound (not copied) after warmup is unseen by the warmed engine, so
   its streams part from a fresh engine's. (d) not gated: steady
   fixed-lane fp32 decode step p50/p99 eager against graphs in turns
   ABBA over 64 steps, the stream's span of each step (CUDA events),
   and the busy share of each from torch.profiler, beside the card.
4g. MoE serving at bench.py decode_moe's width (phase 4's model with 2 KV
   heads and 8 experts, top-2, normalised gates, every 2nd block routed;
   seeded weights): phase 4's REQUESTS as one fixed schedule on
   fixed-lane fp32 and int8 and paged fp32 (page 16) engines, each warmed
   up as CUDA graphs under the sync debug mode "error" with JAX's counts;
   every stream, greedy and seeded, equal eager against graphs; the
   greedy streams through the kernel equal decode_attn="reference" on the
   same schedule, near ties excepted; counters set to 0 after warmup and
   read after: B4 / B5 / B4p = decode steps x depth exactly, every launch
   a replay's, nothing routed. γ 4 with truncated_draft(model, 4) (routed
   blocks 2 and 4): streams equal the plain graph engine's, B4 = rounds x
   γ x 4. The control: the same weights serving top-1 (the second choice
   dropped from the combine) must fail the stream check. Not gated: the
   steady 8-lane fp32 step p50/p99 with graphs against the dense phase-4
   model in turns ABBA, and the busy share of each.
4h. The MoE layer (models/moe.py) at d 1024, F 4096, 8 experts, top-2, n
   2048: the index form the models run against the one-hot plain
   version, fp32 (TF32 off) and bf16, capacity factors 0.5 (drops) and
   2.0: the experts' input buffer bit for bit in fp32; output, aux, the
   input gradient and each parameter's gradient within MOE_LAYER_TOL; a
   dispatch that ignores the capacity must fail; fwd+bwd times of both.
3b. (Runs after 4, so that its large allocations come after the serving
   run's timings.) The flash-attention kernels B1 (forward), B2 (dQ) and
   B3 (dK/dV), bf16 and fp32, against their plain versions: out, lse and
   the three gradients through autograd (random dO, nonzero dLSE), then
   B2 and B3 alone, at full width causal and non-causal, T < S, T > S
   (empty rows), a ragged T, head dim 64, head dim 96 (a padded
   head-dim tile) and ViT-Tiny's attention (B 256, T = S = 65, H 3, D 64,
   non-causal, q/k/v strided views of one fused qkv), each tensor held
   to a relative norm error and an element-wise atol + rtol·|want|
   (FLASH_TOL); three wrong attentions (a dropped interior tile, a
   dropped ragged tail, and at ViT's shape a dK/dV that drops key row
   64) must fail the same check; B1, B2 and B3 run twice on the same
   inputs (the training shape and ViT's) must agree bit for bit (no
   atomics). Then B2's ptxas report, kernel, plain and SDPA times beside
   the bound at the training shape and at ViT's (in fp32 also SDPA's
   kernel names and its error against the plain version: the
   yardstick's own numerics), and fwd+bwd kernel vs plain per length,
   and at ViT's shape kernel vs the dense bf16 path vs SDPA (the data
   for re-measuring FLASH_MIN_LEN).
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
   limits); then the fp32 variant at depth 2. Both write checkpoints to a
   temporary directory each (phase 8a), which phase 8 serves.
5m. (Runs after 8e, on the same temporary directories.) The MoE causal LM
   trained through main() at run_lm_bench's width with --moe_experts 8
   --moe_every 2 --moe_top_k 2 --num_kv_heads 2 (bf16, 2 epochs of 6
   steps, --max_checkpoints 1): each of B1-B3 at least depth x steps,
   nothing routed; losses finite and falling; the reported loss is CE +
   0.01 x the mean aux; the sidecar carries the routing; one step through
   the kernels against the plain attention within STEP_TOL, routing held
   to the kernel step's (a near-tie token would otherwise route to
   another expert on the attention's rounding; the count is printed), and
   a dropped dK tile must fail it; --epochs 3 resumes epoch 1's
   parameters and Adam moments bit for bit; step p50, tokens/s, est. MFU
   by JAX's active-expert flops, busy share and B1-B3's share.
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
7. The image families of BASELINE.json through ``python -m
   ddp_tpu_torch.train``'s own main(), on synthetic splits of 12,800
   images, world 1 over nccl.
   7a: ViT-Tiny on CIFAR-100 (configs 4; bench.py run_vit_bench's model,
   batch 256 and SGD 0.01 + momentum 0.9, bf16, crop-and-flip), 2 epochs:
   launch counters set to 0 before and read after (each of B1-B3 at
   least depth x steps in bf16, nothing routed to the plain block),
   losses finite and falling, epoch_0..1 verified and a re-run resuming
   epoch 1's state bit for bit, one bf16 step through the kernels vs the
   plain attention from the trained weights (STEP_TOL; a B3 that drops
   key row 64 must fail it); step p50, images/s per card, est. MFU and
   the busy share and B1-B3's share of device time under torch.profiler.
   7b: ResNet-18 on CIFAR-10 (config 3; He et al. 2016 §4.2's recipe:
   batch 128, SGD 0.1, momentum 0.9, weight decay 1e-4, crop-and-flip),
   fp32, 2 epochs: losses, checkpoints and a bit-exact resume (BatchNorm
   running buffers included), one step on the card (TF32 off) vs the CPU
   (CNN_STEP_TOL, the running buffers after the step included), the eval
   loss (running averages) against a train-mode forward's; images/s,
   step p50 and busy share, then the same figures in bf16. No kernel of
   the repo lies on ResNet (its convs are cuDNN's).
   7c: vit_moe_tiny (8 experts, top-2, every 2nd of 12 blocks routed, 64
   tokens) on CIFAR-100 with 7a's recipe: launch counters, falling
   losses, a bit-exact resume, one step through the kernels against the
   plain attention (7a's limits and controls; routing held to the kernel
   step's, as 5m); step p50, images/s and busy share.
8. (Runs right after 5, on its checkpoints: about 3.1 GB, removed at the
   end of the phase; check_lm_phases runs 5a, 5 and 8 alone.) From
   training to serving. It prints its wall seconds.
   8a (inside phase 5): epoch_0..1 (bf16) and epoch_0 (fp32) with
   verified manifests and the lm_spec.json sidecar; restore_for_inference
   equals the trainer's parameters bit for bit; the bf16 command again
   with --epochs 3 prints "Resumed from checkpoint epoch 1", trains epoch
   2 alone, and the parameters and Adam moments it restored equal the
   saved ones bit for bit.
   8b: ``python -m ddp_tpu_torch.serve``'s main() with --checkpoint_dir
   <bf16> --epoch 0 --page_size 16 --slots 8, counters read after:
   phase 4c's traffic shape from the training
   distribution (lm_prompts), with POST /reload of epoch 1 once 8
   requests are in flight (200, the prefix flushed; every request
   completes, each stream equal to the fixed-lane engine's under the
   version it reports, near ties excepted), the traffic again (streams
   equal a fresh paged engine's on epoch 1; the first request after the
   swap misses the index), the same reload again (no flush; the index
   keeps its hits), and three reloads that must answer 409 (the depth-2
   directory: spec_skew; an empty one: manifest_missing; the depth-2 one
   with a byte flipped: crc_mismatch), each followed by an unchanged
   stream. B4p launched == decode steps x depth (counters set to 0 once
   the server answers, after main()'s warmup), no fixed-lane launch,
   nothing routed. In-process, where the batching is the same on both
   sides (eager engines: the first logits are read by a Python hook,
   which a graph replay does not run): a paged engine on epoch 0 given
   epoch 1 through install_params with the flush equals a fresh engine's
   first logits bit for bit and its streams; without the flush (the
   control) it must not. 8b-8e serve through main(), which warms up
   before it serves (8e: while the restore thread copies on its own
   stream).
   8c-8d: main() with --checkpoint_dir <bf16> --draft_checkpoint_dir
   <fp32 depth 2> --spec_tokens 4 --model draft=<fp32 depth 2>: phase
   4d's requests (streams equal the plain engine's, near ties by
   replay_gap), flash_decode_fp32 launched exactly rounds x γ x draft
   depth + the named engine's steps x its depth; acceptance, tokens a
   target step, tokens/s and the round's split printed; "model": "draft"
   served by the depth-2 engine (its stream equals that engine's
   in-process, only its counters move), "model": "nope" answers 400
   unknown_model; SIGTERM with 8 requests in flight: a new POST answers
   503 with Retry-After, the 8 complete, main() returns drained.
   8e: main() with --streaming_restore --stream_layers 1 on epoch 1: the
   streams equal 8b's fresh engine's; seconds to admission, to full
   residency and of the monolithic restore printed.
   8f (after 5m): main() with --checkpoint_dir <5m> --page_size 16 on
   lm_prompts traffic: streams equal an in-process fixed-lane engine's on
   the restored weights (near ties excepted), B4p = decode steps x depth,
   nothing else; POST /reload of the dense bf16 directory answers 409
   spec_skew; where the training forward dropped no token, the served
   prompt's last-position logits equal train_forward's (fp32) within
   MOE_LOGITS_ATOL. 5m's checkpoint is removed at the end.
9. The trainer's fault tolerance (check_fault_tolerance; every command
   on the card, every generation's run_start naming it).
   9a: phase 5's LM at run_lm_bench's width (bf16, 2 epochs of 6 steps)
   through main(): the uninterrupted command twice (bitwise equal, or
   their spread logged); the same under --chaos sigterm:rank0@step8
   exits clean with epoch 1 saved at mid_batch 2 (the save's seconds
   printed); the re-run resumes it (seconds from the call to the first
   resumed step's end printed) and ends on the uninterrupted run's
   parameters and Adam state (bitwise, or within the spread); B1-B3
   launched in training steps x depth over the two invocations (the
   evaluations' B1 counted apart); the control, re-entering one batch
   late, must fail the comparison; the synchronizing calls of 8 steady
   LM steps with the watchdog, a chaos engine and the SIGTERM handler
   armed equal those with none; the steady step without and with the
   parameter EMA, timed in turns (a reading).
   9b: SimpleCNN on the reference's path (--epochs 3 --batch_size 64,
   SGD 0.01) on 12,800 synthetic MNIST images, --deterministic, each run
   under the supervisor: two uninterrupted runs; --max_restarts 1 --chaos
   kill:rank0@step300 (the supervisor logs "killed by SIGKILL",
   relaunches, and the run ends on the uninterrupted state by the same
   rule; kill to the next run_start printed); ckpt_corrupt:latest on
   that directory (epoch 2 quarantined, a fallback record, epoch 2
   retrained from epoch 1); --watchdog_timeout 5 --max_restarts 1 --chaos
   stall:input@step250:30s (one exit 124 classified as a watchdog
   timeout, the run completes, the stall in the ledger once).
   9c: --spawn 2 --backend gloo --elastic --min_world 1 --max_restarts 2
   --chaos shrink:rank1@step300,grow:+1@epoch2 on the one card: worlds
   2, 1, 2 by their run_start records, the global batch 64 in each,
   elastic.json as the first generation wrote it, equal epochs.
   9d: phase 7a's ViT-Tiny (bf16, B1-B3 at T 65) with --ema_decay 0.999
   --keep_best --max_checkpoints 1: the EMA within FT_EMA_TOL of an fp64
   recurrence over the card's own parameters after every update (decay
   and 1 - decay rounded to fp32 as JAX applies them), every
   evaluation on the EMA, the EMA bitwise through the checkpoint, the
   directory holding exactly best ∪ latest with their manifests.
   9e: a reference .pt (seeded weights, the module. prefix) through
   python -m ddp_tpu_torch.interop.import_torch_checkpoint: logits on
   the card within FT_IMPORT_ATOL of the CPU forward, then one epoch
   from the imported checkpoint with a finite, falling loss.
10. A "kernels" JSON line (each decode kernel's launches on the MoE path,
   moe_launches, beside its own; B1-B3's in 5m and 7c, and phase 9's as
   fault_tolerance_launches), the card line, and the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
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


# ---- phase 3c: the paged kernels B4p/B5p against their plain versions ----

PAGED_SHAPES = [  # label, S, H, H_kv, Dh, L, page size
    ("full", 8, 8, 8, 128, 256, 16),
    ("full", 8, 8, 8, 128, 256, 64),
    ("gqa", 8, 8, 2, 128, 256, 16),
    ("gqa", 8, 8, 2, 128, 256, 64),
    ("ragged", 8, 8, 8, 128, 200, 8),
    ("long cache", 8, 8, 8, 128, 8192, 16),
    ("long cache", 8, 8, 8, 128, 8192, 64),
]
SERVE_PAGE = 16  # phase 4c's --page_size: the paged times are taken at it
PAGED_NAMES = ("flash_decode_paged_fp32", "flash_decode_paged_int8")


def _paged_inputs(torch, S, H, H_kv, Dh, L, ps, pos, quantized, seed, *,
                  share=True, device="cuda"):
    """q, one layer's slice of a 2-layer page pool [2, P, ps, H_kv, Dh]
    (read in place through strides, as the engine passes it), and an
    int32 table [S, L / ps]: lane s maps the pages of its band (keys <=
    pos[s]; at the position ceiling the whole lane) plus up to two more
    (its decode budget), drawn from a seeded permutation of the pool;
    with ``share`` lanes 0/1 and 2/3 map their first pages in common (a
    forked prefix); past each lane's pages the table holds the scratch
    page 0, and three pages of the pool no lane maps."""
    from ddp_tpu_torch.ops.decode import quantize_kv

    rng = np.random.default_rng(seed)
    lane_pages = L // ps
    demand = [min(lane_pages, -(-(min(p, L - 1) + 1) // ps)
                  + int(rng.integers(0, 3))) for p in pos]
    shared = {}  # (lane, page index) -> the lane whose page it maps
    if share:
        for a, b in ((0, 1), (2, 3)):
            for j in range(min(demand[a], demand[b]) // 2):
                shared[(b, j)] = a
    P = 1 + sum(demand) - len(shared) + 3
    free = [int(x) for x in rng.permutation(np.arange(1, P))]
    table = np.zeros((S, lane_pages), np.int32)
    for s_ in range(S):
        for j in range(demand[s_]):
            table[s_, j] = (table[shared[(s_, j)], j] if (s_, j) in shared
                            else free.pop())
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(S, H, Dh, generator=g, device=device)
    kf = torch.randn(P, ps, H_kv, Dh, generator=g, device=device)
    vf = torch.randn(P, ps, H_kv, Dh, generator=g, device=device)
    dtype = torch.int8 if quantized else torch.float32
    k = torch.zeros(2, P, ps, H_kv, Dh, dtype=dtype, device=device)
    v = torch.zeros_like(k)
    ks = vs = None
    if quantized:
        ks = torch.zeros(2, P, ps, H_kv, device=device)
        vs = torch.zeros_like(ks)
        k[1], ks[1] = quantize_kv(kf)
        v[1], vs[1] = quantize_kv(vf)
        ks, vs = ks[1], vs[1]
    else:
        k[1], v[1] = kf, vf
    return (q, k[1], v[1], torch.from_numpy(table).to(device),
            torch.tensor(pos, dtype=torch.int32, device=device), ks, vs)


def _paged_poisoned(torch, args):
    """The same inputs with every pool row that no lane's band reads (no
    s, key <= min(pos[s], L-1) maps to it; the scratch page and the
    unmapped pages included) made NaN (fp32 K/V; int8: the rows'
    scales), copied."""
    q, k, v, table, pos, ks, vs = args
    P, ps = k.shape[:2]
    L = table.shape[1] * ps
    keys = torch.arange(L, device=k.device)
    band = keys[None, :] <= torch.clamp(pos.long(), max=L - 1)[:, None]
    rows = table.long()[:, keys // ps] * ps + keys % ps
    live = torch.zeros(P * ps, dtype=torch.bool, device=k.device)
    live[rows[band]] = True
    dead = ~live.reshape(P, ps)
    if ks is None:
        k, v = k.clone(), v.clone()
        k[dead], v[dead] = float("nan"), float("nan")
    else:
        ks, vs = ks.clone(), vs.clone()
        ks[dead], vs[dead] = float("nan"), float("nan")
    return q, k, v, table, pos, ks, vs


def _gathered(dec, args):
    """The fixed-lane kernel's inputs for a paged case: the lanes'
    views through the table (``gather_paged_kv``), as the JAX path
    makes them before its kernel."""
    q, k, v, table, pos, ks, vs = args
    g = dec.gather_paged_kv
    return (q, g(k, table), g(v, table), pos,
            None if ks is None else g(ks, table),
            None if vs is None else g(vs, table))


def _paged_bound(S, H, H_kv, Dh, pos, L, ps, quantized):
    """:func:`_bound` plus the table entries the bands read (4 bytes
    each): the paged kernel moves the fixed-lane kernel's bytes and
    those."""
    ms, by = _bound(S, H, H_kv, Dh, pos, L, quantized)
    entries = sum(-(-min(int(p) + 1, L) // ps) for p in pos)
    t_bytes = ms * 1e-3 + 4 * entries / H100_BYTES_PER_S
    return (1e3 * t_bytes, "bytes") if by == "bytes" else (ms, by)


def _time_paged(torch, F, dec, quantized, L) -> dict:
    """At full width, every lane at L-1, page size SERVE_PAGE, each lane
    its own pages in a shuffled pool: the paged kernel; the JAX design
    (gather_paged_kv, then the fixed-lane kernel); the library call
    (the gather, dequantized for int8, then SDPA with the band mask);
    and the plain version, beside the bound."""
    _, S, H, H_kv, Dh, _, _ = PAGED_SHAPES[0]
    ps = SERVE_PAGE
    pos = [L - 1] * S
    args = _paged_inputs(torch, S, H, H_kv, Dh, L, ps, pos, quantized,
                         seed=99, share=False)
    q, k, v, table, pos_t, ks, vs = args
    q4 = q[:, :, None, :]
    mask = (torch.arange(L, device="cuda")[None, :]
            <= pos_t[:, None])[:, None, None, :]

    def library():
        _, gk, gv, _, gks, gvs = _gathered(dec, args)
        if quantized:
            gk, gv = dec.dequantize_kv(gk, gks), dec.dequantize_kv(gv, gvs)
        return F.scaled_dot_product_attention(
            q4, gk.permute(0, 2, 1, 3), gv.permute(0, 2, 1, 3),
            attn_mask=mask)

    lib_err = float((library()[:, :, 0] - dec.paged_decode_attention_reference(
        *args)).abs().max())
    ms = _median_ms(torch, lambda: dec.flash_decode_paged_attention(*args))
    gather_ms = _median_ms(torch, lambda: dec.flash_decode_attention(
        *_gathered(dec, args)), n=20)
    plain_ms = _median_ms(torch, lambda: dec.paged_decode_attention_reference(
        *args), n=10, reps=5)
    library_ms = _median_ms(torch, library, n=20)
    bound_ms, bound_by = _paged_bound(S, H, H_kv, Dh, pos, L, ps, quantized)
    log(f"[paged] {'int8' if quantized else 'fp32'} S={S} H={H} "
        f"H_kv={H_kv} Dh={Dh} L={L} page {ps}, pos={L - 1} on every lane: "
        f"kernel {ms * 1e3:.2f} us, gather + fixed-lane kernel "
        f"{gather_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, gather + "
        f"sdpa {library_ms * 1e3:.2f} us (its error vs plain {lib_err:.1e}), "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms:.3f} of "
        "the bound")
    del args, q, k, v, ks, vs, q4
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                gather_fixed_ms=gather_ms)


def _check_paged_case(torch, dec, args, label) -> tuple[float, list[str]]:
    """One paged case: the kernel against the plain paged version
    (KERNEL_ATOL), bitwise the fixed-lane kernel over the gathered
    lanes, the same bits again and with every row no band reads
    poisoned; a table with two live entries of a lane swapped must fail
    the check: page 0 of lanes 2 and 4 (a swap inside one lane's band
    would only permute its keys, which attention cannot see) →
    (max_abs_err, what did not hold)."""
    q, k, v, table, pos, ks, vs = args
    out = dec.flash_decode_paged_attention(*args)
    again = dec.flash_decode_paged_attention(*args)
    poisoned = dec.flash_decode_paged_attention(*_paged_poisoned(torch, args))
    fixed = dec.flash_decode_attention(*_gathered(dec, args))
    ref = dec.paged_decode_attention_reference(*args)
    swapped = table.clone()
    swapped[[2, 4], 0] = table[[4, 2], 0]
    bad = dec.flash_decode_paged_attention(q, k, v, swapped, pos, ks, vs)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    bad_err = float((bad - ref).abs().max())
    same, clean = torch.equal(out, again), torch.equal(out, poisoned)
    as_fixed = torch.equal(out, fixed)
    log(f"[paged] {label}: max_abs_err {err:.3e} (tolerance {KERNEL_ATOL}); "
        f"bitwise the fixed-lane kernel over the gathered lanes: {as_fixed}; "
        f"same bits on a second call: {same}; rows no band reads poisoned, "
        f"same bits: {clean}; page 0 of lanes 2 and 4 swapped: "
        f"max_abs_err {bad_err:.3e}")
    failed = []
    if not (err <= KERNEL_ATOL and same and clean and as_fixed):
        failed.append(label)
    if bad_err <= KERNEL_ATOL:
        failed.append(f"{label}: the check passes a swapped table")
    return err, failed


def check_paged_kernels(torch) -> dict:
    """Phase 3c: B4p and B5p at every shape of PAGED_SHAPES (positions
    from _decode_positions; the long caches also with every lane at
    L-1) through _check_paged_case, a call of a shape the paged kernel
    does not take (page size 3) routed and counted, then the times at L
    256 and L 8192. Every reading is printed before a failure is
    raised."""
    import torch.nn.functional as F

    from ddp_tpu_torch.ops import decode as dec

    results, failed = {}, []
    rng = np.random.default_rng(4)
    for quantized, name in zip((False, True), PAGED_NAMES):
        errs = []
        cases = []
        for label, S, H, H_kv, Dh, L, ps in PAGED_SHAPES:
            chunk, _ = _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized)
            cases.append((label, S, H, H_kv, Dh, L, ps,
                          _decode_positions(rng, S, L, chunk)))
            if label == "long cache":
                cases.append((label + ", every lane at L-1", S, H, H_kv, Dh,
                              L, ps, [L - 1] * S))
        for i, (label, S, H, H_kv, Dh, L, ps, pos) in enumerate(cases):
            args = _paged_inputs(torch, S, H, H_kv, Dh, L, ps, pos,
                                 quantized, seed=i + 10 * quantized)
            chunk, n = _decode_plan(torch, dec, S, H, H_kv, Dh, L, quantized)
            err, bad = _check_paged_case(
                torch, dec, args,
                f"{name} {label} S={S} H={H} H_kv={H_kv} Dh={Dh} L={L} "
                f"page {ps} ({L // ps} a lane, pool {args[1].shape[0]}; "
                f"{n} chunks of {chunk}), pos {pos[:4]}...")
            errs.append(err)
            failed += bad
            del args
            torch.cuda.empty_cache()
        short, long = (_time_paged(torch, F, dec, quantized, L)
                       for L in DECODE_TIMED_L)
        results[name] = dict(max_abs_err=max(errs), **short,
                             long_cache=dict(L=DECODE_TIMED_L[1], **long))
    args = _paged_inputs(torch, 2, 4, 2, 128, 24, 3, [5, 24], False, seed=5,
                         share=False)
    before = (dict(dec.flash_decode_paged_attention.launches),
              dec.flash_decode_paged_attention.plain_routed)
    got = dec.paged_decode_attention(*args, impl="auto")
    ok = (torch.equal(got, dec.paged_decode_attention_reference(*args))
          and dec.flash_decode_paged_attention.plain_routed == before[1] + 1
          and dec.flash_decode_paged_attention.launches == before[0])
    try:
        dec.flash_decode_paged_attention(*args)
        raised = False
    except ValueError:
        raised = True
    log(f"[paged] page size 3 (not taken): auto routed to the plain version "
        f"and counted: {ok}; an explicit kernel call raises: {raised}")
    if not (ok and raised):
        failed.append("paged routing at page size 3")
    if failed:
        raise AssertionError(f"paged decode kernels: {failed}")
    return results


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
    # ViT-Tiny's attention (phase 7a): 64 patches + cls at batch 256,
    # non-causal, one mostly empty key tile, q/k/v strided views of the
    # fused qkv projection.
    ("ViT non-causal T=S=65", 256, 65, 65, 3, 64, False),
]
VIT_SHAPE = FLASH_SHAPES[-1]
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


def _drop_key_grad(torch, rows: slice):
    """An identity whose backward zeroes key rows ``rows`` of its
    [B, S, H, D] input's gradient: applied to k (and v), what a B3 that
    skipped those keys would give."""
    class DropKeyGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[:, rows] = 0
            return g

    return DropKeyGrad.apply


def _reject_dropped_tail(torch, fl, dtype, dname) -> list[str]:
    """Negative control at ViT's shape: the plain attention with the dK
    and dV of key row 64 (the ragged tail of the one key tile) dropped,
    held against the plain version as the kernel is: dk and dv must fail
    → what did not."""
    _, B, T, S, H, D, causal = VIT_SHAPE
    q, k, v, dout, dlse = _flash_inputs(torch, B, T, S, H, D, dtype, seed=5)
    plain = lambda *a: fl.attention_with_lse_reference(*a, causal)  # noqa: E731
    want = _with_grads(torch, plain, q.float(), k.float(), v.float(),
                       dout.float(), dlse)
    drop = _drop_key_grad(torch, slice(-1, None))
    got = _with_grads(torch, lambda q, k, v: plain(q, drop(k), drop(v)),
                      q, k, v, dout, dlse)
    parts, passed = [], []
    for what in ("dk", "dv"):
        ok, text = _compare(torch, got[what], want[what], FLASH_TOL[dname])
        parts.append(f"{what} {text}")
        if ok:
            passed.append(what)
    log(f"[flash] {dname} control, key row 64 of {VIT_SHAPE[0]} dropped from "
        "dK/dV: " + "; ".join(parts))
    del q, k, v, dout, dlse, want, got
    return ([f"the check passes a B3 that drops the ragged tail: {passed}"]
            if passed else [])


def _check_deterministic(torch, fl, dtype, dname,
                         shape=("the training shape", 8, 2048, 2048, 8, 128,
                                True)) -> list[str]:
    """B1, B2 and B3 twice on the same inputs (``shape``: a FLASH_SHAPES
    entry) must give the same bits: no atomics, no order that changes
    between runs → what differed."""
    label, B, T, S, H, D, causal = shape
    q, k, v, dout, _ = _flash_inputs(torch, B, T, S, H, D, dtype, seed=7)
    runs = []
    for _ in range(2):
        out, lse = fl.flash_forward(q, k, v, causal)
        delta = fl.backward_delta(out, dout)
        dq = fl.flash_dq(q, k, v, dout, lse, delta, causal)
        dk, dv = fl.flash_dkv(q, k, v, dout, lse, delta, causal)
        runs.append(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv))
    torch.cuda.synchronize()
    differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    log(f"[flash] {dname} B1, B2 and B3 run twice at {label}: "
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
        vit_errs = dict(errs)
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
                    err = float(
                        (a.float() - b.float()).abs().nan_to_num(0.0).max())
                    errs[name] = max(errs[name], err)
                    if label == VIT_SHAPE[0]:
                        vit_errs[name] = max(vit_errs[name], err)
            del q, k, v, dout, dlse, got, want, out, lse, delta
            del dq2, dk2, dv2, p_dq, p_dk, p_dv
            torch.cuda.empty_cache()
        failed += _reject_wrong_kernels(torch, fl, dtype, dname)
        failed += _reject_dropped_tail(torch, fl, dtype, dname)
        failed += _check_deterministic(torch, fl, dtype, dname)
        failed += _check_deterministic(torch, fl, dtype, dname, VIT_SHAPE)
        if failed:
            failures[dname] = failed
        results[dname] = _time_flash(torch, F, fl, dtype, dname, errs)
        results[f"vit_{dname}"] = _time_flash(torch, F, fl, dtype, dname,
                                              vit_errs, VIT_SHAPE)
    _flash_min_len_data(torch, fl)
    _vit_attention_data(torch, F, fl)
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


def _time_flash(torch, F, fl, dtype, dname, errs,
                shape=("the training shape",) + TRAIN_SHAPE) -> dict:
    """Kernel, plain version and SDPA times at a main path's shape: the
    causal LM's training step (B 8, T = S 2048, H 8, D 128, causal), or
    ViT-Tiny's (VIT_SHAPE)."""
    label, B, T, S, H, D, causal = shape
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
        qs, ks, vs, is_causal=causal), n=n, reps=reps)
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    do_s = dout.transpose(1, 2)
    sdpa_bwd_ms = _median_ms(torch, lambda: torch.autograd.grad(
        o_s, (qs, ks, vs), do_s, retain_graph=True), n=n, reps=reps)
    if dname == "fp32" and shape[1:] == TRAIN_SHAPE:
        _log_sdpa_numerics(torch, F, fl, qs, ks, vs, qf, kf, vf)
    pairs, nbytes = _flash_counts(B, T, S, H, D, causal, q.element_size())
    res = {}
    for name in FLASH_NAMES:
        ms = _median_ms(torch, kernel[name], n=n, reps=reps)
        plain_ms = _median_ms(torch, plain[name], n=2, reps=3)
        bound_ms, bound_by = _flash_bound(name, pairs, nbytes, D, dname)
        library_ms = sdpa_fwd_ms if name == "flash_attn_fwd" else None
        log(f"[flash] {name} {dname} {label} B={B} T=S={T} H={H} D={D} "
            f"{'causal' if causal else 'non-causal'}: "
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


def _vit_attention_data(torch, F, fl) -> None:
    """fwd+bwd time at ViT's shape (VIT_SHAPE, bf16, non-causal): the
    kernels, the dense bf16 path of ops.attention (what the JAX package
    runs below FLASH_MIN_LEN keys) and SDPA (the yardstick): the data for
    re-measuring FLASH_MIN_LEN at T 65."""
    from ddp_tpu_torch.ops.attention import dot_product_attention

    _, B, T, S, H, D, causal = VIT_SHAPE
    q, k, v, dout, _ = _flash_inputs(torch, B, T, S, H, D, torch.bfloat16,
                                     seed=65)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def run(fn, layout=lambda x: x):
        out = fn(*(layout(x) for x in leaves))
        torch.autograd.grad(out, leaves, layout(dout))

    heads_first = lambda x: x.transpose(1, 2)  # noqa: E731
    ms = {
        "kernel": _median_ms(torch, lambda: run(
            lambda *a: fl.flash_attention(*a, causal)), n=10, reps=5),
        "dense bf16": _median_ms(torch, lambda: run(
            lambda *a: dot_product_attention(*a, causal=causal)), n=10,
            reps=5),
        "sdpa": _median_ms(torch, lambda: run(
            lambda *a: F.scaled_dot_product_attention(*a, is_causal=causal),
            heads_first), n=10, reps=5),
    }
    log(f"[flash] FLASH_MIN_LEN data, {VIT_SHAPE[0]} B={B} H={H} D={D} bf16 "
        "fwd+bwd: " + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in ms.items()))
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
    kernel path, after ``warmup()`` (the serve CLI's start) and with the
    launch counters set to 0 after it → (completions by index,
    engine)."""
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.engine import ServeEngine
    from ddp_tpu_torch.serve.server import LMServer

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         kv_dtype=kv_dtype)
    engine.warmup()
    _zero_decode_counters(dec)
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


def replay_gap(torch, model, prompt, stream, j, kv_dtype,
               sampling=None) -> float:
    """Top-2 logit gap of the plain path at token ``j`` (>= 1) of a lone
    request: the engine's chunk plan for the prompt, then one plain
    decode step per earlier token, on a one-slot cache. For a sampled
    request (``sampling``: its temperature, top_p and seed) the gap is
    of the scores its draw compares: logits / T, nucleus-filtered, plus
    the Gumbel noise of step ``j``."""
    from ddp_tpu_torch.models.generate import (
        gumbel_noise,
        init_slot_cache,
        nucleus_filter,
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
    scores = logits[0]
    temp = (sampling or {}).get("temperature", 0.0)
    if temp > 0:
        scores = scores / temp
        top_p = sampling.get("top_p", 1.0)
        if top_p < 1.0:
            scores = nucleus_filter(scores, top_p)
        scores = scores + gumbel_noise(
            torch.tensor([sampling.get("seed", 0)], device=dev),
            torch.tensor([j], device=dev), spec.vocab_size)[0]
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1])


def profile_steps(torch, model, *, steps=16, page_size=0, label="",
                  **engine_kw) -> dict:
    """Device busy share of steady decode steps (all 8 lanes decoding,
    fp32 KV, kernel path; paged with ``page_size``; other engine knobs,
    such as speculation's or ``cuda_graphs``, in ``engine_kw``), from
    torch.profiler: summed CUDA kernel time over the wall time of
    ``steps`` engine steps, and the top kernels → {"busy": share,
    "kernel_us_per_step": µs} (empty when the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         page_size=page_size, **engine_kw)
    rng = np.random.default_rng(2)
    # Budgets long enough for every timed step to decode every lane,
    # under speculation too (up to γ tokens a step).
    n_new = 64 if not engine.spec_tokens else (
        model.spec.total_len - 64 - engine.spec_tokens)
    for _ in range(SLOTS):
        engine.submit(rng.integers(0, model.spec.vocab_size, 64).tolist(),
                      n_new)
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
        return {}
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    kernels = sum(e.count for e in rows) / steps
    log(f"[profile] {steps} decode steps, 8 lanes, fp32 KV"
        f"{f', page {page_size}' if page_size else ''}{label}: wall "
        f"{wall * 1e3:.2f} ms, device kernel time {busy_us / 1e3:.2f} ms, "
        f"busy share {busy_us / 1e6 / wall:.3f}, {kernels:.1f} kernels a "
        f"step")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / steps:9.1f} us/step "
            f"x{e.count // steps:<3d} {e.key[:90]}")
    return {"busy": busy_us / 1e6 / wall, "kernel_us_per_step": busy_us / steps,
            "kernels_per_step": kernels}


# ---- phase 4c: paged serving with a shared prefix, end to end -----------

# bench.py run_serve_prefix_bench's traffic (bench.py:1107): one seed
# request publishes the 96-token system prompt, then a burst of requests
# of that prefix plus a 16-token tail, 32 new tokens each, greedy.
PREFIX_TOKENS, TAIL_TOKENS, PREFIX_NEW, PREFIX_BURST = 96, 16, 32, 24
PREFIX_SEED = 0
# Extra flags for main(): empty on the card (rehearse on the CPU with
# ["--device", "cpu"]).
SERVE_DEVICE_ARGS: list[str] = []
# A pool that cannot hold every lane's pages at once: 6 shared prefix
# pages + 8 lanes x 3 private pages need 30 of its 23 usable pages, so
# binds starve and retired tails are evicted (LRU).
EVICT_KV_PAGES = 24
# bench.py's floors: scheduling facts of this traffic, not timings.
MIN_HIT_RATE, MIN_EFFECTIVE_SLOTS = 0.5, 1.5


def prefix_prompts(vocab: int, seed: int = PREFIX_SEED) -> list[list[int]]:
    """The seed request's prompt, then the burst's: one prefix, a tail
    each, from ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PREFIX_TOKENS).tolist()
    return [prefix + rng.integers(0, vocab, TAIL_TOKENS).tolist()
            for _ in range(1 + PREFIX_BURST)]


def _get(url: str, route: str) -> dict:
    with urllib.request.urlopen(url + route, timeout=60) as r:
        return json.loads(r.read())


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_main_run(torch, prompts, *, kv_dtype, kv_pages=None):
    """``python -m ddp_tpu_torch.serve``'s own main() at phase 4's full
    width with --page_size SERVE_PAGE (serve_main_with), while a client
    thread sends the seed request alone and then the burst concurrently
    over HTTP → (replies by index, the engine, peak effective-slots
    multiplier, wall seconds of the traffic)."""
    replies, peaks, wall = {}, [], []

    def traffic(url, made, stop):
        t0 = time.perf_counter()
        replies.update(prefix_traffic(url, prompts))
        wall.append(time.perf_counter() - t0)

    def peak(engine):
        # The effective-slots multiplier after every step, as bench.py
        # reads it.
        peaks.append(engine.page_stats()["effective_slots_multiplier"]
                     or 0.0)

    spec = FULL
    argv = ["--init_demo", "--seed", "0",
            "--vocab_size", str(spec["vocab_size"]),
            "--seq_len", str(spec["total_len"]),
            "--d_model", str(spec["d_model"]), "--depth", str(spec["depth"]),
            "--num_heads", str(spec["num_heads"]), "--slots", str(SLOTS),
            "--prefill_len", str(PREFILL_LEN), "--kv_dtype", kv_dtype,
            "--page_size", str(SERVE_PAGE)]
    if kv_pages:
        argv += ["--kv_pages", str(kv_pages)]
    made, _ = serve_main_with(torch, argv, traffic, on_step=peak)
    return replies, made[0], max(peaks, default=0.0), wall[0]


def fixed_lane_streams(torch, model, prompts, *, kv_dtype) -> list:
    """The same traffic on the fixed-lane engine in this process (the
    seed request alone, then the burst) → each request's tokens."""
    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         kv_dtype=kv_dtype, max_queue=len(prompts))
    rids = [engine.submit(prompts[0], PREFIX_NEW).request.rid]
    engine.run()
    rids += [engine.submit(p, PREFIX_NEW).request.rid for p in prompts[1:]]
    engine.run()
    out = []
    for r in rids:
        c = engine.pop_result(r)
        if c.status != "complete":
            raise AssertionError(f"fixed-lane request {r}: {c.status}")
        out.append(c.tokens)
    return out


def _pct_ms(values, q):
    return float(np.percentile(values, q)) * 1e3 if values else float("nan")


def check_paged_run(torch, model, prompts, fixed, *, kv_dtype, kv_pages=None):
    """One phase-4c run: counters to 0 once main()'s server answers
    (after its warmup), read just after; every request complete; streams
    identical to the fixed-lane engine's (or parted only at a near tie,
    as phase 4 allows); the floors of bench.py; paged kernel launches ==
    decode steps x depth, no fixed-lane launch, nothing routed to a
    plain version → the paged kernel's launches."""
    from ddp_tpu_torch.ops import decode as dec

    paged, flat = dec.flash_decode_paged_attention, dec.flash_decode_attention
    for counts in (paged.launches, flat.launches):
        for k in counts:
            counts[k] = 0
    paged.plain_routed = flat.plain_routed = 0
    replies, engine, peak, wall = serve_main_run(
        torch, prompts, kv_dtype=kv_dtype, kv_pages=kv_pages)
    launches, fixed_launches = dict(paged.launches), dict(flat.launches)
    routed = paged.plain_routed + flat.plain_routed
    name = PAGED_NAMES[kv_dtype == "int8"]
    label = f"kv={kv_dtype}" + (f" kv_pages={kv_pages}" if kv_pages else "")
    failed = []
    for i in range(len(prompts)):
        r = replies.get(i)
        if (r is None or r["status"] != "complete"
                or len(r["tokens"]) != PREFIX_NEW):
            failed.append(f"request {i}: {r and r['status']}")
    if failed:
        raise AssertionError(f"phase 4c {label}: {failed}")
    parted = 0
    for i in range(len(prompts)):
        a, b = replies[i]["tokens"], fixed[i]
        if a == b:
            continue
        parted += 1
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = replay_gap(torch, model, prompts[i], b, j, kv_dtype)
        log(f"[serve-paged] {label} request {i}: paged and fixed-lane "
            f"streams part at token {j}; top-2 logit gap {gap:.3e}")
        if gap >= DIVERGENCE_GAP:
            failed.append(f"request {i} diverged at gap {gap}")
    st = engine.page_stats()
    hits = [r["ttft_s"] for r in replies.values() if r["prefix_hit_tokens"]]
    misses = [r["ttft_s"] for r in replies.values()
              if not r["prefix_hit_tokens"]]
    steps = engine.decode_steps
    decode_tokens = sum(len(r["tokens"]) - 1 for r in replies.values())
    log(f"[serve-paged] {label}: {len(prompts)} requests complete, "
        f"{len(prompts) - parted} streams identical to the fixed-lane "
        f"engine's, {parted} parted at a near tie; wall {wall:.3f} s, "
        f"{steps} decode steps, decode {decode_tokens / wall:.1f} tokens/s; "
        f"TTFT hit p50 {_pct_ms(hits, 50):.1f} ms p99 "
        f"{_pct_ms(hits, 99):.1f} ms ({len(hits)}), miss p50 "
        f"{_pct_ms(misses, 50):.1f} ms p99 {_pct_ms(misses, 99):.1f} ms "
        f"({len(misses)}); step p50 "
        f"{engine.step_latency.percentile(50) * 1e3:.2f} ms p99 "
        f"{engine.step_latency.percentile(99) * 1e3:.2f} ms")
    log(f"[serve-paged] {label}: prefix hit rate {st['prefix_hit_rate']} "
        f"(floor {MIN_HIT_RATE}), peak effective slots {peak} (floor "
        f"{MIN_EFFECTIVE_SLOTS}), evicted pages {st['evicted_pages']}, "
        f"starved binds {st['page_starved_binds']}; launches {launches} "
        f"(decode steps x depth = {steps * FULL['depth']}), fixed-lane "
        f"{fixed_launches}, routed to a plain version {routed}")
    if st["prefix_hit_rate"] is None or st["prefix_hit_rate"] < MIN_HIT_RATE:
        failed.append(f"hit rate {st['prefix_hit_rate']}")
    if peak <= MIN_EFFECTIVE_SLOTS:
        failed.append(f"peak effective slots {peak}")
    if (engine.decode_attn != "flash" or launches[name] == 0
            or launches[name] != steps * FULL["depth"]
            or sum(launches.values()) != launches[name]):
        failed.append(f"{name} launches {launches}")
    if any(fixed_launches.values()) or routed:
        failed.append(f"fixed-lane launches {fixed_launches}, routed {routed}")
    if kv_pages and not (st["evicted_pages"] and st["page_starved_binds"]):
        failed.append("the small pool neither evicted nor starved a bind")
    if failed:
        raise AssertionError(f"phase 4c {label}: {failed}")
    return launches[name]


def check_paged_serving(torch) -> dict:
    """Phase 4c: paged serving of bench.py's shared-prefix traffic through
    ``python -m ddp_tpu_torch.serve``'s main(), fp32 and int8 KV, then
    fp32 on a pool of EVICT_KV_PAGES; then the busy share of steady
    paged decode steps → the paged kernels' launches."""
    from ddp_tpu_torch.models.lm import LMSpec, init_lm

    spec = LMSpec(**FULL)
    model = init_lm(spec, seed=0)
    prompts = prefix_prompts(spec.vocab_size)
    counted = {}
    for kv_dtype, name in zip(("fp32", "int8"), PAGED_NAMES):
        fixed = fixed_lane_streams(torch, model, prompts, kv_dtype=kv_dtype)
        counted[name] = check_paged_run(torch, model, prompts, fixed,
                                        kv_dtype=kv_dtype)
        if kv_dtype == "fp32":
            check_paged_run(torch, model, prompts, fixed, kv_dtype=kv_dtype,
                            kv_pages=EVICT_KV_PAGES)
    profile_steps(torch, model, page_size=SERVE_PAGE)
    return counted


# ---- phase 4d: speculative decoding in serving, end to end ---------------

# bench.py's speculative variants (bench.py:960-983): γ 4, a draft of the
# target's first depth // 2 blocks sharing its weights; the self-draft is
# all of them.
SPEC_GAMMA, DRAFT_DEPTH = 4, 4
# A budget no chunk plan ever meets: each prompt's chunk split is then
# its own (as a lone request's), whatever the decode lanes cost, so the
# speculative and plain engines ingest every prompt alike.
SPEC_BUDGET = SLOTS * (64 + SPEC_GAMMA)
# bench.py _variant's traffic (bench.py:909-923): 2 x slots requests,
# prompts of 8-64 tokens, 128 new tokens each, from seed 1.
VARIANT_NEW, VARIANT_SEED = 128, 1


def _zero_decode_counters(dec) -> None:
    for wrapper in (dec.flash_decode_attention,
                    dec.flash_decode_paged_attention):
        for k in wrapper.launches:
            wrapper.launches[k] = 0
        wrapper.plain_routed = 0


def _spec_launch_failures(dec, engine, depth) -> tuple[dict, list[str]]:
    """Counters read after a speculative run: B4 launched exactly draft
    steps x draft depth times, no B5, B4p or B5p launch, nothing routed
    to a plain version → (launches, failures)."""
    flat = dict(dec.flash_decode_attention.launches)
    paged = dict(dec.flash_decode_paged_attention.launches)
    routed = (dec.flash_decode_attention.plain_routed
              + dec.flash_decode_paged_attention.plain_routed)
    want = engine.decode_steps * engine.spec_tokens * depth
    failed = []
    if engine.draft_decode_attn != "flash" or want == 0:
        failed.append(f"draft path {engine.draft_decode_attn}, {want} "
                      "draft layer steps")
    if flat["flash_decode_fp32"] != want:
        failed.append(f"flash_decode_fp32 {flat['flash_decode_fp32']} != "
                      f"draft steps x depth {want}")
    if flat["flash_decode_int8"] or any(paged.values()) or routed:
        failed.append(f"unexpected launches {flat} {paged}, routed {routed}")
    return {**flat, **paged, "routed": routed, "want": want}, failed


def _stream_failures(torch, model, prompts, got, want, kv_dtype, label,
                     sampling=None) -> tuple[int, list[str]]:
    """Streams ``got`` against ``want`` (index → tokens): equal, or
    parted only at a near tie of the plain path (replay_gap; sampled
    requests by the scores their draw compares) → (parted, failures)."""
    parted, failed = 0, []
    for i in sorted(want):
        a, b = got[i], want[i]
        if a == b:
            continue
        parted += 1
        if len(a) != len(b):
            failed.append(f"request {i}: {len(a)} tokens, not {len(b)}")
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        if j == 0:
            failed.append(f"request {i} parts at its first token")
            continue
        gap = replay_gap(torch, model, prompts[i], b, j, kv_dtype,
                         sampling=(sampling or {}).get(i))
        log(f"[spec] {label} request {i}: streams part at token {j}; "
            f"gap {gap:.3e}")
        if gap >= DIVERGENCE_GAP:
            failed.append(f"request {i} diverged at token {j}, gap {gap}")
    return parted, failed


def spec_requests() -> dict:
    """Phase 4's REQUESTS by index, each budget capped at the speculative
    admission ceiling (total_len - (γ - 1): the verify round's reserve;
    only the 128 + 128 request shrinks, to 125 new tokens)."""
    ceiling = FULL["total_len"] - (SPEC_GAMMA - 1)
    return {i: (n, min(new, ceiling - n), s)
            for i, (n, new, s) in enumerate(REQUESTS)}


def spec_streams(torch, model, prompts, *, kv_dtype, draft=None,
                 cases=None, watch=None, warmup=False, sync_error=False,
                 **engine_kw) -> tuple[dict, object]:
    """``cases`` (index → (prompt_len, new tokens, sampling); default
    spec_requests()) submitted at once and run to idle in-process under
    SPEC_BUDGET, speculative with ``draft`` at SPEC_GAMMA or plain
    without one (other engine knobs in ``engine_kw``); ``warmup``
    prepares the program set first (``sync_error``: under torch's sync
    debug mode "error", which raises at a host sync inside a captured
    step) and then sets the decode counters to 0; ``watch(engine)`` is
    called before the first step → ({index: tokens}, engine)."""
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.engine import ServeEngine

    cases = cases or spec_requests()
    knobs = dict(spec_tokens=SPEC_GAMMA, draft_model=draft) if draft else {}
    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         kv_dtype=kv_dtype, step_token_budget=SPEC_BUDGET,
                         max_queue=len(cases), **knobs, **engine_kw)
    if warmup:
        if sync_error:
            torch.cuda.set_sync_debug_mode("error")
        try:
            counts = engine.warmup()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if counts != _expected_counts(engine) or not engine.cuda_graphs:
            raise AssertionError(f"warmup() {counts}, want "
                                 f"{_expected_counts(engine)}, graphs "
                                 f"{engine.cuda_graphs}")
        _zero_decode_counters(dec)
    if watch:
        watch(engine)
    rids = {i: engine.submit(prompts[i], n_new, **sampling).request.rid
            for i, (_, n_new, sampling) in cases.items()}
    engine.run()
    torch.cuda.synchronize()
    out = {}
    for i, rid in rids.items():
        c = engine.pop_result(rid)
        if c.status != "complete" or len(c.tokens) != cases[i][1]:
            raise AssertionError(f"phase 4d request {i}: {c.status}, "
                                 f"{len(c.tokens)}/{cases[i][1]}")
        out[i] = c.tokens
    return out, engine


@contextlib.contextmanager
def near_tie_probe(torch, gaps: list):
    """While open, every speculative engine built inside appends to
    ``gaps``, every round, the target's top-2 logit gap at each live
    lane's first rejected position (a self-draft rejects only where draft
    and target order a near tie differently). generate's block sampler
    is replaced for the whole run, so the verify program's graph captures
    the probe: it copies each round's [S, γ] gaps into a buffer made at
    the program's first (side-stream, uncaptured) call, which the host
    reads after the round. ``watch(engine)`` installs the reading."""
    import ddp_tpu_torch.models.generate as gen

    real_sampler = gen.sample_slot_tokens_block
    buf = []

    def sampler(logits, *a, **kw):
        top = torch.topk(logits, 2, dim=-1).values
        if not buf:
            buf.append(torch.empty(top.shape[:-1], device=logits.device))
        buf[0].copy_(top[..., 0] - top[..., 1])
        return real_sampler(logits, *a, **kw)

    def watch(engine):
        real_verify = engine._verify

        def verify():
            live = [i for i, s in enumerate(engine._slots)
                    if s.decoding and s.emitted < s.request.max_new_tokens]
            out = real_verify()
            matched = out[:, -1].tolist()
            gap = buf[0].tolist()
            gaps.extend(gap[i][matched[i]] for i in live
                        if matched[i] < engine.spec_tokens)
            return out

        engine._verify = verify

    gen.sample_slot_tokens_block = sampler
    try:
        yield watch
    finally:
        gen.sample_slot_tokens_block = real_sampler


def _time_round(torch, engine) -> dict:
    """Wrap the engine's draft proposal and verify in CUDA events (no
    synchronize: the round runs as it would) → per part, the list of
    (start, end) event pairs, filled as the engine runs; read them after
    a synchronize."""
    split = {"draft_ms": [], "verify_ms": []}
    propose, verify = engine._draft_propose, engine._verify

    def timed(fn, key):
        def call(*a):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*a)
            end.record()
            split[key].append((start, end))
            return out
        return call

    engine._draft_propose = timed(propose, "draft_ms")
    engine._verify = timed(verify, "verify_ms")
    return split


def time_spec_variant(torch, model, label, draft=None, **engine_kw) -> dict:
    """bench.py _variant's traffic on one engine (fp32 KV, default
    budget, other knobs in ``engine_kw``): 16 requests submitted at once,
    one step to settle, then the step latencies and the wall time of the
    rest, logged → the readings."""
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.engine import ServeEngine
    from ddp_tpu_torch.utils.metrics import StatSummary

    knobs = dict(spec_tokens=SPEC_GAMMA, draft_model=draft) if draft else {}
    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         max_queue=4 * SLOTS, **knobs, **engine_kw)
    engine.warmup()  # the serve CLI's start: no capture in the timed run
    split = _time_round(torch, engine) if draft else None
    rng = np.random.default_rng(VARIANT_SEED)
    for _ in range(2 * SLOTS):
        plen = int(rng.integers(8, max(9, PREFILL_LEN // 2 + 1)))
        adm = engine.submit(
            rng.integers(0, model.spec.vocab_size, plen).tolist(),
            VARIANT_NEW)
        if not adm.accepted:
            raise AssertionError(f"phase 4d {label}: {adm.reason}")
    _zero_decode_counters(dec)
    engine.step()
    engine.step_latency = StatSummary()
    t0 = time.perf_counter()
    while engine.pending:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in engine._completed.values())
    lat = engine.step_latency
    out = {
        "tokens_per_s": tokens / wall, "tokens": tokens, "wall_s": wall,
        "step_p50_ms": lat.percentile(50) * 1e3,
        "step_p99_ms": lat.percentile(99) * 1e3,
        "target_steps": engine.decode_steps,
        "tokens_per_target_step": tokens / max(1, engine.decode_steps),
        "acceptance": engine.spec_acceptance_rate(),
        "b4_launches": dec.flash_decode_attention.launches[
            "flash_decode_fp32"],
    }
    if draft:
        out["b4_per_round"] = out["b4_launches"] / engine.decode_steps
        # The steady rounds: all but the first 8 (prefill waves settle).
        for key in ("draft_ms", "verify_ms"):
            out[key + "_p50"] = float(np.median(
                [a.elapsed_time(b) for a, b in split[key][8:]]))
    log(f"[spec-time] {label}: {tokens} tokens in {wall:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s, {engine.decode_steps} target "
        f"steps ({out['tokens_per_target_step']:.3f} tokens a step), step "
        f"p50 {out['step_p50_ms']:.2f} ms p99 {out['step_p99_ms']:.2f} ms, "
        f"acceptance {out['acceptance']}, B4 launches {out['b4_launches']}"
        + (f" ({out['b4_per_round']:.1f} a round); steady round: "
           f"{SPEC_GAMMA} draft steps {out['draft_ms_p50']:.3f} ms, verify "
           f"{out['verify_ms_p50']:.3f} ms (CUDA events, median)"
           if draft else ""))
    return out


def check_spec_serving(torch, card) -> dict:
    """Phase 4d: speculative decoding at phase 4's full width → the
    truncated draft's B4 launches in its fp32 run."""
    import ddp_tpu_torch.serve.engine as engine_mod
    from ddp_tpu_torch.models.lm import LMSpec, init_lm, truncated_draft
    from ddp_tpu_torch.ops import decode as dec

    spec = LMSpec(**FULL)
    model = init_lm(spec, seed=0)
    draft = truncated_draft(model, DRAFT_DEPTH)
    selfd = truncated_draft(model, spec.depth)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    sampling = {i: s for i, (_, _, s) in enumerate(REQUESTS) if s}
    failed, counted = [], {}

    # 1-2. REQUESTS with the truncated draft, fp32 and int8 target KV.
    for kv_dtype in ("fp32", "int8"):
        want, _ = spec_streams(torch, model, prompts, kv_dtype=kv_dtype)
        _zero_decode_counters(dec)
        got, engine = spec_streams(torch, model, prompts, kv_dtype=kv_dtype,
                                   draft=draft)
        launches, bad = _spec_launch_failures(dec, engine, DRAFT_DEPTH)
        parted, bad2 = _stream_failures(torch, model, prompts, got, want,
                                        kv_dtype, f"kv={kv_dtype}", sampling)
        log(f"[spec] kv={kv_dtype} truncated draft (depth {DRAFT_DEPTH}), "
            f"γ {SPEC_GAMMA}: {len(got)} streams, {len(got) - parted} "
            f"identical to the plain engine's, {parted} parted at a near "
            f"tie; acceptance {engine.spec_acceptance_rate():.4f}, "
            f"{engine.decode_steps} rounds; launches {launches}")
        failed += [f"kv={kv_dtype}: {f}" for f in bad + bad2]
        counted[kv_dtype] = launches["flash_decode_fp32"]

    # 3. The self-draft: every rejection a near tie of the target.
    greedy = {i: c for i, c in spec_requests().items() if not c[2]}
    rejected: list = []
    _zero_decode_counters(dec)
    with near_tie_probe(torch, rejected) as watch:
        got, engine = spec_streams(torch, model, prompts, kv_dtype="fp32",
                                   draft=selfd, cases=greedy, watch=watch)
    launches, bad = _spec_launch_failures(dec, engine, spec.depth)
    want_greedy, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                                  cases=greedy)
    parted, bad2 = _stream_failures(torch, model, prompts, got, want_greedy,
                                    "fp32", "self-draft")
    wide = [g for g in rejected if g >= DIVERGENCE_GAP]
    log(f"[spec] self-draft (depth {spec.depth}), γ {SPEC_GAMMA}, greedy: "
        f"acceptance {engine.spec_acceptance_rate():.4f}, {len(rejected)} "
        f"rejections, largest target gap at one "
        f"{max(rejected, default=0.0):.3e}; {parted} streams parted; "
        f"launches {launches}")
    failed += [f"self-draft: {f}" for f in bad + bad2]
    if wide:
        failed.append(f"self-draft rejected {len(wide)} positions with a "
                      f"target gap >= {DIVERGENCE_GAP}: {wide[:5]}")

    # 4. Paged (page 16) on phase 4c's prefix traffic, against the plain
    #    fixed-lane engine.
    from ddp_tpu_torch.serve.engine import ServeEngine

    pprompts = prefix_prompts(spec.vocab_size)
    fixed = fixed_lane_streams(torch, model, pprompts, kv_dtype="fp32")
    _zero_decode_counters(dec)
    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         page_size=SERVE_PAGE, max_queue=len(pprompts),
                         spec_tokens=SPEC_GAMMA, draft_model=draft)
    rids = [engine.submit(pprompts[0], PREFIX_NEW).request.rid]
    engine.run()
    rids += [engine.submit(p, PREFIX_NEW).request.rid for p in pprompts[1:]]
    engine.run()
    torch.cuda.synchronize()
    done = [engine.pop_result(r) for r in rids]
    launches, bad = _spec_launch_failures(dec, engine, DRAFT_DEPTH)
    if any(c.status != "complete" for c in done):
        bad.append("a paged request did not complete")
    parted, bad2 = _stream_failures(
        torch, model, pprompts, {i: c.tokens for i, c in enumerate(done)},
        dict(enumerate(fixed)), "fp32", "paged")
    st = engine.page_stats()
    log(f"[spec] paged (page {SERVE_PAGE}), truncated draft, γ "
        f"{SPEC_GAMMA}: {len(done)} requests, {len(done) - parted} streams "
        f"identical to the plain fixed-lane engine's, {parted} parted at a "
        f"near tie; hit rate {st['prefix_hit_rate']}, acceptance "
        f"{engine.spec_acceptance_rate():.4f}; launches {launches}")
    failed += [f"paged: {f}" for f in bad + bad2]

    # 6. Negative control: a verify that counts the first mismatch as a
    #    match must fail the stream check.
    real = engine_mod.slot_verify_step

    def over_accepts(*a, **kw):
        nxt, tgt, matched = real(*a, **kw)
        return nxt, tgt, torch.clamp(matched + 1, max=tgt.shape[1])

    engine_mod.slot_verify_step = over_accepts
    try:
        got, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                              draft=draft, cases=greedy)
    finally:
        engine_mod.slot_verify_step = real
    _, caught = _stream_failures(torch, model, prompts, got, want_greedy,
                                 "fp32", "over-accepting verify")
    log(f"[spec] negative control (matched + 1): the stream check "
        f"{'rejects' if caught else 'ACCEPTS'} it ({len(caught)} streams)")
    if not caught:
        failed.append("the stream check accepted an over-accepting verify")
    if failed:
        raise AssertionError(f"phase 4d: {failed}")

    # 7. Timing on bench.py _variant's traffic, then the busy share of
    #    steady rounds.
    log(f"[spec-time] {card}")
    time_spec_variant(torch, model, "plain")
    time_spec_variant(torch, model, "spec, truncated draft", draft)
    time_spec_variant(torch, model, "spec, self-draft", selfd)
    for label, d in (("truncated draft", draft), ("self-draft", selfd)):
        profile_steps(torch, model, label=f", spec γ {SPEC_GAMMA} {label}",
                      spec_tokens=SPEC_GAMMA, draft_model=d)
    return counted


# ---- phase 4e: serving observability --------------------------------------

# scripts/serve.py's example objectives (its --slo help): every objective
# kind, and a TTFT bound this traffic's burst can breach.
OBS_SLO = "ttft_p99<0.5s,tpot_p50<80ms,availability>0.999"
# A context no parser takes: counted orphaned, the request still served.
BAD_CONTEXT = "00-not-a-trace-context"
SYNC_STEPS = 32  # (c): steady decode steps counted
OVERHEAD_STEPS = 64  # (d): steady decode steps timed a run


def _get_text(url: str, route: str) -> tuple[str, str]:
    with urllib.request.urlopen(url + route, timeout=60) as r:
        return r.headers["Content-Type"], r.read().decode()


def requestz_events(doc: dict) -> list[dict]:
    """A /requestz timeline → the events reconstruct_requests makes of an
    exported trace (µs; spans with their dur, instants as "n"; the
    request umbrella from the digest's total), for
    validate_request_timeline."""
    out = [{"name": "request", "ph": "X", "ts": 0.0,
            "dur": doc["summary"]["total_s"] * 1e6}]
    for e in doc["events"]:
        ev = {"name": e["name"], "ts": e["t_s"] * 1e6,
              **({"args": e["args"]} if e.get("args") else {})}
        if e["dur_s"] > 0:
            ev.update(ph="X", dur=e["dur_s"] * 1e6)
        else:
            ev["ph"] = "n"
        out.append(ev)
    return sorted(out, key=lambda e: e["ts"])


def _timeline_failures(doc, prompt_len, reply, label) -> list[str]:
    """One completion's /requestz timeline: it validates, its prefill
    tokens are the prompt minus the prefix hit, its decode tokens the new
    tokens minus the first, and it retires complete."""
    from ddp_tpu_torch.obs.reqtrace import validate_request_timeline

    failed = []
    try:
        summary = validate_request_timeline(requestz_events(doc))
    except ValueError as e:
        return [f"{label}: {e}"]
    args = {}
    for e in doc["events"]:
        args.setdefault(e["name"], []).append(e.get("args") or {})
    prefill = sum(a["tokens"] for a in args.get("req.prefill_chunk", []))
    decode = sum(a["tokens"] for a in args.get("req.decode", []))
    if prefill != prompt_len - reply["prefix_hit_tokens"]:
        failed.append(f"{label}: prefill tokens {prefill} != "
                      f"{prompt_len} - {reply['prefix_hit_tokens']}")
    if decode != len(reply["tokens"]) - 1:
        failed.append(f"{label}: decode tokens {decode} != "
                      f"{len(reply['tokens'])} - 1")
    if summary["reason"] != "complete":
        failed.append(f"{label}: retired {summary['reason']}")
    return failed


def _metricsz_failures(torch, ctype, text, stats) -> list[str]:
    """/metricsz lints, agrees with /stats, has every objective's gauges
    and a build_info naming the card."""
    from ddp_tpu_torch.obs.promtext import CONTENT_TYPE, validate_promtext

    failed = []
    try:
        n = validate_promtext(text)
    except ValueError as e:
        return [f"/metricsz does not lint: {e}"]
    if ctype != CONTENT_TYPE:
        failed.append(f"/metricsz content type {ctype!r}")
    lines = set(text.splitlines())
    pg = stats["paged"]
    want = {"ddp_tpu_serve_steps_total": stats["steps"],
            "ddp_tpu_serve_tokens_total": stats["tokens_total"],
            "ddp_tpu_serve_prefix_hits_total": pg["prefix_hits"],
            "ddp_tpu_serve_prefix_misses_total": pg["prefix_misses"],
            "ddp_tpu_serve_pages_free": pg["pages_free"],
            "ddp_tpu_serve_pages_resident": pg["pages_resident"],
            "ddp_tpu_serve_pages_shared": pg["pages_shared"]}
    want.update({f'ddp_tpu_serve_requests_total{{status="{s}"}}': c
                 for s, c in stats["requests_by_status"].items()})
    for name, value in want.items():
        if f"{name} {value}" not in lines:
            failed.append(f"/metricsz {name} is not /stats' {value}")
    for obj in ("ttft_p99", "tpot_p50", "availability"):
        for gauge in ("target", "current", "breached"):
            if not any(l.startswith(f'ddp_tpu_slo_{gauge}{{objective="{obj}"')
                       for l in lines):
                failed.append(f"/metricsz lacks ddp_tpu_slo_{gauge} of {obj}")
    card = torch.cuda.get_device_name(0)
    info = [l for l in lines if l.startswith("ddp_tpu_build_info{")]
    if len(info) != 1 or f'device="{card}"' not in info[0]:
        failed.append(f"build_info does not name {card}: {info}")
    log(f"[obs] /metricsz: {n} samples, lint clean"
        if not failed else f"[obs] /metricsz: {failed}")
    return failed


def check_obs_http(torch, model, prompts, fixed, tmp) -> tuple[int, list]:
    """Phase 4e (a): main() with every observability flag on, paged fp32
    (phase 4c's run), bench.py's prefix traffic plus a request with a
    valid trace context and one with a malformed one; counters to 0 just
    before main(), read just after → (B4p launches, failures)."""
    import os

    from ddp_tpu_torch.obs.recorder import load_dump
    from ddp_tpu_torch.obs.reqtrace import (
        encode_trace_context,
        format_trace_id,
        reconstruct_requests,
    )
    from ddp_tpu_torch.obs.tracer import validate_trace_file
    from ddp_tpu_torch.ops import decode as dec

    good_tid, good_span = 0x5EED0000C0FFEE01, 0x00000000000ABCDE
    extra = {1: encode_trace_context(good_tid, good_span),
             2: BAD_CONTEXT}  # prompt index → context
    replies, reads = {}, {}

    def traffic(url, made, stop):
        replies.update(prefix_traffic(url, prompts))
        for i, ctx in extra.items():
            replies[f"ctx{i}"] = _post(url, {
                "prompt_tokens": prompts[i], "max_new_tokens": PREFIX_NEW,
                "trace": ctx})
        # The SLO engine evaluates at most once a min_eval_interval_s and
        # serves its cached states in between (JAX's throttle); with the
        # step graphs the whole burst can retire inside one interval of
        # its construction, so the scrape waits the interval out.
        time.sleep(made[0]._slo.min_eval_interval_s)
        reads["stats"] = _get(url, "/stats")
        reads["metricsz"] = _get_text(url, "/metricsz")
        reads["statusz"] = _get(url, "/statusz")
        for key, r in replies.items():
            tid = _get(url, f"/requestz?id={r['rid']}")["trace_id"]
            reads[key] = _get(url, f"/requestz?id={tid}")

    spec = FULL
    trace_dir, flight_dir = os.path.join(tmp, "trace"), os.path.join(
        tmp, "flight")
    argv = ["--init_demo", "--seed", "0",
            "--vocab_size", str(spec["vocab_size"]),
            "--seq_len", str(spec["total_len"]),
            "--d_model", str(spec["d_model"]), "--depth", str(spec["depth"]),
            "--num_heads", str(spec["num_heads"]), "--slots", str(SLOTS),
            "--prefill_len", str(PREFILL_LEN), "--page_size",
            str(SERVE_PAGE), "--reqtrace", "--slo", OBS_SLO,
            "--trace_dir", trace_dir, "--flight_dir", flight_dir]
    _zero_decode_counters(dec)
    t0 = time.perf_counter()
    made, lines = serve_main_with(torch, argv, traffic)
    wall = time.perf_counter() - t0
    paged = dict(dec.flash_decode_paged_attention.launches)
    flat = dict(dec.flash_decode_attention.launches)
    routed = (dec.flash_decode_attention.plain_routed
              + dec.flash_decode_paged_attention.plain_routed)
    engine, failed = made[0], []
    steps = engine.decode_steps
    # Streams: phase 4c's fixed-lane ones (near ties excepted, as there).
    got = {i: replies[i]["tokens"] for i in range(len(prompts))}
    got.update({100 + i: replies[f"ctx{i}"]["tokens"] for i in extra})
    want = {**dict(enumerate(fixed)), **{100 + i: fixed[i] for i in extra}}
    ps = {**dict(enumerate(prompts)), **{100 + i: prompts[i] for i in extra}}
    if any(r["status"] != "complete" for r in replies.values()):
        failed.append("a request did not complete")
    parted, bad = _stream_failures(torch, model, ps, got, want, "fp32",
                                   "obs")
    failed += bad
    want_b4p = steps * FULL["depth"]
    if (paged["flash_decode_paged_fp32"] != want_b4p or want_b4p == 0
            or paged["flash_decode_paged_int8"] or any(flat.values())
            or routed):
        failed.append(f"launches {paged} {flat} (want B4p = decode steps x "
                      f"depth = {want_b4p}), routed {routed}")
    failed += _metricsz_failures(torch, *reads["metricsz"], reads["stats"])
    # /requestz: every completion's timeline.
    for key, r in replies.items():
        plen = len(prompts[key if isinstance(key, int) else int(key[3:])])
        failed += _timeline_failures(reads[key], plen, r, f"request {key}")
    # Inbound contexts: the valid one adopted and echoed, the malformed
    # one orphaned and served.
    ok_doc = reads["ctx1"]
    if (replies["ctx1"].get("trace_id") != format_trace_id(good_tid)
            or ok_doc["trace_id"] != format_trace_id(good_tid)
            or ok_doc["summary"].get("parent") != f"{good_span:016x}"):
        failed.append(f"the valid context was not adopted: "
                      f"{replies['ctx1'].get('trace_id')} {ok_doc['summary']}")
    if "trace_id" in replies["ctx2"]:
        failed.append("the malformed context was echoed")
    rt = reads["stats"]["reqtrace"]
    if (rt.get("propagated"), rt.get("orphaned")) != (1, 1):
        failed.append(f"propagated/orphaned {rt}")
    # /statusz's trace loads as a traceEvents document.
    status_path = os.path.join(tmp, "statusz_trace.json")
    with open(status_path, "w") as f:
        json.dump(reads["statusz"]["trace"], f)
    try:
        n_status = len(validate_trace_file(status_path)["traceEvents"])
    except ValueError as e:
        failed.append(f"/statusz trace: {e}")
        n_status = 0
    # Shutdown: the exported trace and the flight dump.
    printed = {k: v for line in lines if line.startswith("{")
               for k, v in json.loads(line).items()}
    ids = {doc["trace_id"] for key, doc in reads.items()
           if key not in ("stats", "metricsz", "statusz")}
    try:
        doc = validate_trace_file(printed["trace"])
        found = set(reconstruct_requests(doc["traceEvents"]))
        summaries = doc["ddp_tpu"]["span_summaries"]
        if found != ids:
            failed.append(f"the exported trace holds {len(found)} requests, "
                          f"not the {len(ids)} served")
    except (KeyError, ValueError) as e:
        failed.append(f"exported trace: {e!r}")
        summaries = {}
    try:
        dump = load_dump(printed["flight"])
    except (KeyError, ValueError) as e:
        failed.append(f"flight dump: {e!r}")
        dump = {"records": []}
    slo = reads["stats"]["slo"]
    log(f"[obs] (a) main() with --reqtrace --slo --trace_dir --flight_dir, "
        f"paged fp32: {len(replies)} requests in {wall:.1f} s, {steps} decode "
        f"steps, B4p launches {paged['flash_decode_paged_fp32']} (= {want_b4p}"
        f"), routed {routed}; {len(got) - parted} streams identical to phase "
        f"4c's fixed-lane engine, {parted} parted at a near tie; reqtrace "
        f"{rt}; SLO {[(o['name'], o['current'], o['breached']) for o in slo['objectives']]}"
        f"; /statusz trace {n_status} events; exported trace "
        f"{len(ids)} requests, spans "
        f"{ {k: v['count'] for k, v in summaries.items()} }; flight dump "
        f"{len(dump['records'])} records")
    for name, s in sorted(summaries.items()):
        state_n = s["count"]
        mean = s["sum"] / state_n if state_n else float("nan")
        log(f"[obs]   span {name}: {state_n} spans, mean {mean * 1e3:.3f} ms "
            "(the tracer in its measuring mode)")
    return paged["flash_decode_paged_fp32"], failed


def check_obs_spec(torch, model, prompts) -> tuple[int, list]:
    """Phase 4e (b): phase 4d's γ 4 truncated draft on its REQUESTS with
    request tracing on: the spec_round events summed over every timeline
    are the engine's drafted and accepted totals; B4 launches rounds x γ
    x draft depth → (B4 launches, failures)."""
    from ddp_tpu_torch.models.lm import truncated_draft
    from ddp_tpu_torch.ops import decode as dec

    draft = truncated_draft(model, DRAFT_DEPTH)
    _zero_decode_counters(dec)
    _, engine = spec_streams(torch, model, prompts, kv_dtype="fp32",
                             draft=draft, reqtrace=True)
    launches, failed = _spec_launch_failures(dec, engine, DRAFT_DEPTH)
    drafted = accepted = rounds = 0
    recent = engine._reqtrace.recent(limit=len(REQUESTS))
    for r in recent:
        for e in engine.request_timeline(r["rid"])["events"]:
            if e["name"] == "req.spec_round":
                drafted += e["args"]["drafted"]
                accepted += e["args"]["accepted"]
                rounds += 1
    if len(recent) != len(REQUESTS):
        failed.append(f"{len(recent)} timelines for {len(REQUESTS)} requests")
    if (drafted, accepted) != (engine.spec_drafted_total,
                               engine.spec_accepted_total):
        failed.append(f"spec_round events drafted {drafted} accepted "
                      f"{accepted} != engine {engine.spec_drafted_total} "
                      f"{engine.spec_accepted_total}")
    log(f"[obs] (b) speculative, truncated draft γ {SPEC_GAMMA}, request "
        f"tracing on: {rounds} spec_round events over {len(recent)} "
        f"timelines, drafted {drafted} / accepted {accepted} (engine "
        f"{engine.spec_drafted_total} / {engine.spec_accepted_total}); "
        f"{engine.decode_steps} rounds; launches {launches}")
    return launches["flash_decode_fp32"], failed


def steady_engine(torch, model, *, steps=16, **engine_kw):
    """A fixed-lane or paged engine at 8 lanes with every lane decoding
    (prompts of 32 tokens from seed 3, prefill done after ``steps``
    steps, budgets long enough that no lane finishes for ~200 steps),
    warmed up first where the engine has ``warmup()``."""
    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                         **engine_kw)
    if hasattr(engine, "warmup"):  # the serve CLI's start (this tree's)
        engine.warmup()
    rng = np.random.default_rng(3)
    prompt_len = 32
    for _ in range(SLOTS):
        adm = engine.submit(
            rng.integers(0, model.spec.vocab_size, prompt_len).tolist(),
            model.spec.total_len - prompt_len
            - max(1, engine_kw.get("spec_tokens", 0)))
        if not adm.accepted:
            raise AssertionError(f"steady_engine: {adm.reason}")
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    return engine


def _sync_kinds(torch) -> dict:
    """Which waits torch's sync debug mode reports: a stream synchronize,
    an event synchronize and a device synchronize, each called once under
    the "warn" mode → {kind: seen}."""
    import warnings

    event = torch.cuda.Event()
    event.record()
    calls = {"stream": lambda: torch.cuda.current_stream().synchronize(),
             "event": event.synchronize,
             "device": torch.cuda.synchronize}
    seen = {}
    for kind, call in calls.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        seen[kind] = any("synchroniz" in str(w.message) for w in caught)
    return seen


def count_syncs(torch, engine, steps, seen, run=None) -> dict:
    """``steps`` engine steps (or ``run()``, when given) under the sync
    debug mode "warn": its warnings, plus, through wrappers, the waits the
    mode does not report (``seen`` from _sync_kinds) → {"debug_mode": n,
    "<kind>_wrapper": n, "total": n}."""
    import warnings

    counts = {"debug_mode": 0}
    originals = {"stream": (torch.cuda.Stream, "synchronize"),
                 "event": (torch.cuda.Event, "synchronize"),
                 "device": (torch.cuda, "synchronize")}
    saved = {}
    for kind, (owner, attr) in originals.items():
        if seen[kind]:
            continue
        counts[f"{kind}_wrapper"] = 0
        real = getattr(owner, attr)
        saved[kind] = vars(owner).get(attr)

        def wrapped(*a, _real=real, _key=f"{kind}_wrapper", **kw):
            counts[_key] += 1
            return _real(*a, **kw)

        setattr(owner, attr, wrapped)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if run is not None:
                    run()
                for _ in range(steps):
                    engine.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        for kind, own in saved.items():
            owner, attr = originals[kind]
            if own is None:
                delattr(owner, attr)  # the inherited method shows again
            else:
                setattr(owner, attr, own)
    counts["debug_mode"] = sum("synchroniz" in str(w.message) for w in caught)
    counts["total"] = sum(counts.values())
    return counts


def check_obs_syncs(torch, model) -> list:
    """Phase 4e (c): synchronizing calls over SYNC_STEPS steady decode
    steps of the fixed-lane fp32 engine, with request tracing and an SLO
    engine on (tracer off) and with everything off: equal. With the
    tracer's measuring mode on too: more by exactly one wait a span that
    waits (serve.decode, serve.prefill_chunk) → failures."""
    from ddp_tpu_torch.obs.slo import SLOEngine
    from ddp_tpu_torch.obs.tracer import Tracer

    seen = _sync_kinds(torch)
    runs = {
        "off": {},
        "reqtrace+slo": dict(reqtrace=True, slo=SLOEngine(OBS_SLO)),
        "reqtrace+slo+tracer": dict(reqtrace=True, slo=SLOEngine(OBS_SLO),
                                    tracer=Tracer(enabled=True)),
    }
    counts, spans = {}, {}
    for label, kw in runs.items():
        engine = steady_engine(torch, model, **kw)
        before = {k: v["count"] for k, v in engine.tracer.summaries().items()}
        counts[label] = count_syncs(torch, engine, SYNC_STEPS, seen)
        after = engine.tracer.summaries()
        spans[label] = sum(
            after[k]["count"] - before.get(k, 0)
            for k in ("serve.decode", "serve.prefill_chunk") if k in after)
        if engine.active != SLOTS:
            raise AssertionError(f"phase 4e (c) {label}: a lane finished")
    log(f"[obs] (c) the sync debug mode reports {seen} (the others are "
        f"counted by wrappers); {SYNC_STEPS} steady decode steps: "
        + "; ".join(f"{k}: {v}, waiting spans {spans[k]}"
                    for k, v in counts.items()))
    failed = []
    if counts["reqtrace+slo"] != counts["off"]:
        failed.append(f"request tracing changed the synchronizing calls: "
                      f"{counts['reqtrace+slo']} vs {counts['off']}")
    traced = counts["reqtrace+slo+tracer"]["total"]
    if traced != counts["off"]["total"] + spans["reqtrace+slo+tracer"]:
        failed.append(f"the measuring mode made {traced} synchronizing calls,"
                      f" not {counts['off']['total']} + one a span "
                      f"({spans['reqtrace+slo+tracer']})")
    return failed


def time_obs_overhead(torch, model, card) -> dict:
    """Phase 4e (d), not gated: steady decode step p50/p99 (host clock,
    the engine's step_latency over OVERHEAD_STEPS steps after a warm
    prefill) on one seeded schedule, everything off / request tracing +
    SLO / that + the tracer's measuring mode, in turns (ABCCBA) →
    {label: [(p50 ms, p99 ms), ...]}."""
    from ddp_tpu_torch.obs.slo import SLOEngine
    from ddp_tpu_torch.obs.tracer import Tracer
    from ddp_tpu_torch.utils.metrics import StatSummary

    def knobs(label):
        return {"off": {},
                "reqtrace+slo": dict(reqtrace=True, slo=SLOEngine(OBS_SLO)),
                "reqtrace+slo+tracer": dict(
                    reqtrace=True, slo=SLOEngine(OBS_SLO),
                    tracer=Tracer(enabled=True))}[label]

    order = ["off", "reqtrace+slo", "reqtrace+slo+tracer"]
    out = {label: [] for label in order}
    for label in order + order[::-1]:
        engine = steady_engine(torch, model, **knobs(label))
        engine.step_latency = StatSummary()
        for _ in range(OVERHEAD_STEPS):
            engine.step()
        torch.cuda.synchronize()
        lat = engine.step_latency
        out[label].append((round(lat.percentile(50) * 1e3, 4),
                           round(lat.percentile(99) * 1e3, 4)))
    log(f"[obs] (d) {card}; steady fp32 decode step p50 / p99 ms over "
        f"{OVERHEAD_STEPS} steps, runs in turns ABCCBA: "
        + "; ".join(f"{k} {v}" for k, v in out.items()))
    return out


def check_serving_obs(torch, card) -> dict:
    """Phase 4e: serving observability at phase 4c's full width →
    {"b4p": B4p launches of (a), "b4": B4 launches of (b), "overhead"}."""
    import tempfile

    from ddp_tpu_torch.models.lm import LMSpec, init_lm

    t0 = time.perf_counter()
    spec = LMSpec(**FULL)
    model = init_lm(spec, seed=0)
    pprompts = prefix_prompts(spec.vocab_size)
    fixed = fixed_lane_streams(torch, model, pprompts, kv_dtype="fp32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        b4p, failed = check_obs_http(torch, model, pprompts, fixed, tmp)
    b4, bad = check_obs_spec(torch, model, prompts)
    failed += bad
    failed += check_obs_syncs(torch, model)
    overhead = time_obs_overhead(torch, model, card)
    log(f"[obs] phase 4e wall {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"phase 4e: {failed}")
    return {"b4p": b4p, "b4": b4, "overhead": overhead}


# ---- phase 4f: the compile contract, step programs as CUDA graphs ---------

GRAPH_STEPS = 64  # (d): steady decode steps timed a turn
# (b): phase 4's REQUESTS as one fixed schedule (all at once, in-process,
# under SPEC_BUDGET), on each cache layout and dtype.
GRAPH_RUNS = {"fp32": {"kv_dtype": "fp32"}, "int8": {"kv_dtype": "int8"},
              "paged fp32": {"kv_dtype": "fp32", "page_size": SERVE_PAGE},
              "paged int8": {"kv_dtype": "int8", "page_size": SERVE_PAGE}}


def _expected_counts(engine) -> dict:
    """JAX's warmup() counts for the engine's knobs: a first-chunk and a
    continuation program per bucket, one decode; with speculation the
    draft's chunk programs, one draft-decode and one verify."""
    n = len(engine.buckets)
    want = {"prefill_first": n, "prefill_chunk": n, "decode": 1}
    if engine.spec_tokens:
        want.update(draft_prefill_first=n, draft_prefill_chunk=n,
                    draft_decode=1, spec_verify=1)
    return want


def check_graph_warmup(torch, model, draft) -> tuple[dict, list]:
    """Phase 4f (a) and (g): ``warmup()`` on an idle engine of each kind
    (fixed-lane fp32 and int8, paged fp32, speculative γ SPEC_GAMMA with
    the truncated draft) → counts equal JAX's and their sum the budget;
    capture seconds and the graph pool's bytes printed. The fixed-lane
    fp32 engine warms up under torch's sync debug mode "error": a host
    sync (or an upload of a Python scalar) inside a captured step
    raises → (readings, failures)."""
    from ddp_tpu_torch.serve.engine import ServeEngine

    kinds = {"fp32": {}, "int8": {"kv_dtype": "int8"},
             "paged fp32": {"page_size": SERVE_PAGE},
             f"spec γ {SPEC_GAMMA}": {"spec_tokens": SPEC_GAMMA,
                                      "draft_model": draft}}
    readings, failed = {}, []
    for label, kw in kinds.items():
        engine = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                             **kw)
        t0 = time.perf_counter()
        if label == "fp32":
            torch.cuda.set_sync_debug_mode("error")
        try:
            counts = engine.warmup()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
        want = _expected_counts(engine)
        pool = engine.graph_pool_bytes()
        readings[label] = {"counts": counts, "budget":
                           engine.compile_budget(), "warmup_s": wall,
                           "capture_s": engine.capture_seconds(),
                           "pool_bytes": pool}
        log(f"[graphs] (a) {label}: warmup() {counts} (JAX's {want}), sum "
            f"{sum(counts.values())} / budget {engine.compile_budget()}; "
            f"{wall:.3f} s ({engine.capture_seconds():.3f} s in warm runs "
            f"and captures"
            f"{', under the sync debug mode error' if label == 'fp32' else ''}"
            f"); graph pool {pool} bytes; launches a replay "
            f"{engine._programs.per_replay()}")
        if (counts != want or sum(counts.values()) != engine.compile_budget()
                or not engine.cuda_graphs):
            failed.append(f"(a) {label}: counts {counts}, want {want}, "
                          f"graphs {engine.cuda_graphs}")
        del engine
    return readings, failed


def _graph_launch_failures(dec, engine, label) -> tuple[dict, list]:
    """Phase 4f (c), after a run of an engine warmed up with the counters
    set to 0 after warmup: every launch since was a graph replay's, so
    each counter equals Σ replays x the launches its program recorded at
    capture, and the target's kernel launched decode steps x depth (or,
    speculative, rounds x γ x draft depth) → (launches, failures)."""
    got = {**dec.flash_decode_attention.launches,
           **dec.flash_decode_paged_attention.launches,
           "routed": dec.flash_decode_attention.plain_routed
           + dec.flash_decode_paged_attention.plain_routed}
    replayed = engine._programs.replayed_counts()
    failed = []
    for k, n in got.items():
        key = k if k != "routed" else None
        want = 0 if key is None else replayed.get(key, 0)
        if n != want:
            failed.append(f"(c) {label}: {k} {n} != replays x per-replay "
                          f"{want}")
    if engine.spec_tokens:
        name = "flash_decode_fp32"
        want = (engine.decode_steps * engine.spec_tokens
                * engine.draft_model.spec.depth)
    else:
        name = ("flash_decode_paged_" if engine.paged else "flash_decode_"
                ) + engine.kv_dtype
        want = engine.decode_steps * engine.spec.depth
    if got[name] != want or want == 0:
        failed.append(f"(c) {label}: {name} {got[name]} != {want}")
    return got, failed


def check_graph_streams(torch, model, prompts) -> tuple[dict, list]:
    """Phase 4f (b) and (c): phase 4's fixed schedule, eager
    (``cuda_graphs=False``) against graphs (warmed up, counters to 0
    after), fp32 / int8 / paged fp32 / paged int8: every stream, greedy
    and seeded, equal token for token; the graph run's counters equal its
    replays' (c); no program added after warmup → (graph launches by
    kernel, failures)."""
    from ddp_tpu_torch.ops import decode as dec

    cases = dict(enumerate(REQUESTS))
    launched, failed = {}, []
    for label, kw in GRAPH_RUNS.items():
        eager, _ = spec_streams(torch, model, prompts, cases=cases,
                                cuda_graphs=False, **kw)
        got, engine = spec_streams(torch, model, prompts, cases=cases,
                                   warmup=True, **kw)
        launches, bad = _graph_launch_failures(dec, engine, label)
        same = sum(got[i] == eager[i] for i in cases)
        counts = engine.compile_counts()
        log(f"[graphs] (b) {label}: {same}/{len(cases)} streams of the graph "
            f"engine equal the eager engine's token for token; "
            f"{engine.decode_steps} decode steps, launches {launches} "
            f"(replays x per-replay: {engine._programs.replayed_counts()}); "
            f"compile_counts after the traffic {counts}")
        if same != len(cases):
            bad.append(f"(b) {label}: {len(cases) - same} streams differ")
        if counts != _expected_counts(engine):
            bad.append(f"(b) {label}: the traffic added programs {counts}")
        failed += bad
        for k, n in launches.items():
            if k != "routed" and n:
                launched[k] = launched.get(k, 0) + n
    return launched, failed


def time_graph_steps(torch, model, card) -> dict:
    """Phase 4f (d), not gated: steady fixed-lane fp32 decode step
    p50/p99 (host clock, the engine's step_latency over GRAPH_STEPS steps
    after warmup and the prefill), eager against graphs in turns ABBA,
    with CUDA events around each step (the stream's span of the step's
    work: for a graph its replay, for eager its launches and the gaps
    between them); then the busy share of each from torch.profiler →
    readings."""
    from ddp_tpu_torch.utils.metrics import StatSummary

    out = {"eager": [], "graphs": []}
    for label in ("eager", "graphs", "graphs", "eager"):
        engine = steady_engine(torch, model, cuda_graphs=label == "graphs")
        engine.step_latency = StatSummary()
        spans = []
        t0 = time.perf_counter()
        for _ in range(GRAPH_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            engine.step()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lat = engine.step_latency
        span_ms = sum(a.elapsed_time(b) for a, b in spans)
        out[label].append({"p50_ms": lat.percentile(50) * 1e3,
                           "p99_ms": lat.percentile(99) * 1e3,
                           "stream_span_share": span_ms / 1e3 / wall})
        if engine.decode_steps < GRAPH_STEPS or engine.active != SLOTS:
            raise AssertionError("phase 4f (d): a timed step did not "
                                 "decode every lane")
        del engine
    prof = {label: profile_steps(torch, model, steps=GRAPH_STEPS,
                                 label=f", {label}",
                                 cuda_graphs=label == "graphs")
            for label in ("eager", "graphs")}
    log(f"[graphs] (d) {card}; steady fixed-lane fp32 decode step over "
        f"{GRAPH_STEPS} steps, turns ABBA (eager, graphs, graphs, eager): "
        + "; ".join(f"{k}: " + ", ".join(
            f"p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms stream span "
            f"share {r['stream_span_share']:.3f}" for r in v)
            for k, v in out.items())
        + "; torch.profiler busy share / kernel µs a step / kernels a "
        "step: " + ", ".join(
            f"{k} {v.get('busy')} / {v.get('kernel_us_per_step')} / "
            f"{v.get('kernels_per_step')}" for k, v in prof.items()))
    return {"turns": out, "profile": prof}


def check_graph_spec(torch, model, prompts, draft) -> tuple[dict, list]:
    """Phase 4f (e): γ SPEC_GAMMA rounds through the draft_decode and
    spec_verify graphs (truncated draft, fp32, warmed up): phase 4d's
    requests, streams equal the plain graph engine's (near ties by
    replay_gap, as 4d), launches equal the replays'; then tokens/s on
    bench.py _variant's traffic, plain and self-draft, graphs and eager,
    beside the truncated draft with graphs → (readings, failures)."""
    from ddp_tpu_torch.models.lm import truncated_draft
    from ddp_tpu_torch.ops import decode as dec

    sampling = {i: s for i, (_, _, s) in enumerate(REQUESTS) if s}
    want, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                           warmup=True)
    got, engine = spec_streams(torch, model, prompts, kv_dtype="fp32",
                               draft=draft, warmup=True)
    launches, failed = _graph_launch_failures(dec, engine, "spec")
    parted, bad = _stream_failures(torch, model, prompts, got, want, "fp32",
                                   "graphs, spec", sampling)
    failed += bad
    log(f"[graphs] (e) γ {SPEC_GAMMA} truncated draft through the graphs: "
        f"{len(got) - parted}/{len(got)} streams identical to the plain "
        f"graph engine's, {parted} parted at a near tie; {engine.decode_steps}"
        f" rounds, launches {launches}")
    selfd = truncated_draft(model, model.spec.depth)
    rates = {}
    for label, d, graphs in (("plain, graphs", None, True),
                             ("plain, eager", None, False),
                             ("self-draft, graphs", selfd, True),
                             ("self-draft, eager", selfd, False),
                             ("truncated draft, graphs", draft, True)):
        r = time_spec_variant(torch, model, f"4f {label}", d,
                              cuda_graphs=graphs)
        rates[label] = r["tokens_per_s"]
    log(f"[graphs] (e) tokens/s on _variant's traffic: {rates}")
    return {"tokens_per_s": rates, "b4": launches["flash_decode_fp32"]}, failed


def check_rebound_weight(torch, prompts) -> list:
    """Phase 4f (f), the control: a graph reads each weight at its
    address at capture, so a weight REBOUND after warmup (a new Parameter,
    not a copy into the old one) is invisible to the warmed engine. Its
    greedy streams must part from a fresh engine's on the rebound model
    (which is what check (b) would catch), while an eager engine on the
    rebound model equals the fresh one → failures."""
    from ddp_tpu_torch.models.lm import LMSpec, init_lm
    from ddp_tpu_torch.serve.engine import ServeEngine

    spec = LMSpec(**FULL)
    model = init_lm(spec, seed=0)
    other = init_lm(spec, seed=5)
    greedy = {i: c for i, c in enumerate(REQUESTS) if not c[2]}
    stale = ServeEngine(model, slots=SLOTS, prefill_len=PREFILL_LEN,
                        step_token_budget=SPEC_BUDGET, max_queue=len(greedy))
    stale.warmup()
    blk = model.blocks[0]
    kept = blk.mlp2.weight  # the captured storage stays alive
    blk.mlp2.weight = torch.nn.Parameter(other.blocks[0].mlp2.weight.detach()
                                         .clone())
    rids = {i: stale.submit(prompts[i], n).request.rid
            for i, (_, n, _) in greedy.items()}
    stale.run()
    warmed = {i: stale.pop_result(r).tokens for i, r in rids.items()}
    fresh, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                            cases=greedy, warmup=True)
    eager, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                            cases=greedy, cuda_graphs=False)
    parted = sum(warmed[i] != fresh[i] for i in greedy)
    same = sum(eager[i] == fresh[i] for i in greedy)
    log(f"[graphs] (f) control, block 0's mlp2 weight rebound after "
        f"warmup: {parted}/{len(greedy)} greedy streams of the warmed "
        f"engine part from a fresh graph engine's on the rebound model "
        f"(must be > 0); an eager engine equals the fresh one on "
        f"{same}/{len(greedy)}")
    del kept
    failed = []
    if not parted:
        failed.append("(f) a rebound weight went unseen by the stream check")
    if same != len(greedy):
        failed.append(f"(f) eager and fresh graph engines part on "
                      f"{len(greedy) - same} streams")
    return failed


def check_graphs(torch, card) -> dict:
    """Phase 4f: the serving engine's compile contract at phase 4's full
    width → {"launches": graph launches by kernel, "b4_spec": B4 launches
    of (e), readings}."""
    from ddp_tpu_torch.models.lm import LMSpec, init_lm, truncated_draft

    t0 = time.perf_counter()
    spec = LMSpec(**FULL)
    model = init_lm(spec, seed=0)
    draft = truncated_draft(model, DRAFT_DEPTH)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    log(f"[graphs] {card}")
    warm, failed = check_graph_warmup(torch, model, draft)
    launched, bad = check_graph_streams(torch, model, prompts)
    failed += bad
    spec_readings, bad = check_graph_spec(torch, model, prompts, draft)
    failed += bad
    failed += check_rebound_weight(torch, prompts)
    timing = time_graph_steps(torch, model, card)
    log(f"[graphs] phase 4f wall {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"phase 4f: {failed}")
    return {"launches": launched, "b4_spec": spec_readings["b4"],
            "warmup": warm, "timing": timing,
            "tokens_per_s": spec_readings["tokens_per_s"]}


# ---- phase 4g: MoE serving at bench.py decode_moe's width ----------------

# bench.py decode_moe, run_decode_bench(num_kv_heads=2, num_experts=8)
# (bench.py:3537-3538, 600-629): phase 4's model with 2 KV heads and 8
# experts, top-2, normalised gates, routing every 2nd block's MLP.
MOE_FULL = dict(FULL, num_kv_heads=2, num_experts=8)
MOE_RUNS = {"fp32": {"kv_dtype": "fp32"}, "int8": {"kv_dtype": "int8"},
            "paged fp32": {"kv_dtype": "fp32", "page_size": SERVE_PAGE}}


def check_moe_runs(torch, model, prompts) -> tuple[dict, dict, list]:
    """Phase 4g (a)-(c): phase 4's REQUESTS as one fixed schedule on the
    MoE model, fixed-lane fp32 and int8 and paged fp32 (page 16): eager
    (``cuda_graphs=False``) against graphs (warmed up under the sync debug
    mode "error", JAX's warmup counts, counters set to 0 after), every
    stream equal token for token; the graph run's counters equal its
    replays' and decode steps x depth, nothing routed; then the greedy
    streams through the kernel against ``decode_attn="reference"`` on the
    same schedule, near ties excepted (phase 4's rule) → (launches by
    kernel, fp32 graph streams, failures)."""
    from ddp_tpu_torch.ops import decode as dec

    cases = dict(enumerate(REQUESTS))
    greedy = {i for i, (_, _, smp) in cases.items() if not smp}
    launched, failed, fp32 = {}, [], {}
    for label, kw in MOE_RUNS.items():
        eager, _ = spec_streams(torch, model, prompts, cases=cases,
                                cuda_graphs=False, **kw)
        got, engine = spec_streams(torch, model, prompts, cases=cases,
                                   warmup=True, sync_error=True, **kw)
        launches, bad = _graph_launch_failures(dec, engine, f"4g {label}")
        steps = engine.decode_steps
        parted, bad_ref = 0, []
        if "page_size" not in kw:  # phase 4's pair: fp32 and int8
            ref, _ = spec_streams(torch, model, prompts, cases=cases,
                                  decode_attn="reference", warmup=True, **kw)
            parted, bad_ref = _stream_failures(
                torch, model, prompts, {i: got[i] for i in greedy},
                {i: ref[i] for i in greedy}, kw["kv_dtype"], f"4g {label}")
        same = sum(got[i] == eager[i] for i in cases)
        log(f"[moe] (b) {label}: {same}/{len(cases)} graph streams equal the "
            f"eager engine's token for token; greedy kernel vs reference "
            + (f"{len(greedy) - parted}/{len(greedy)} identical, {parted} "
               f"parted at a near tie" if "page_size" not in kw else
               "not run (fixed-lane only)")
            + f"; {steps} decode steps, launches {launches} "
            f"(replays x per-replay {engine._programs.replayed_counts()}); "
            f"compile_counts {engine.compile_counts()}")
        if same != len(cases):
            bad.append(f"(b) {label}: {len(cases) - same} streams differ")
        if engine.compile_counts() != _expected_counts(engine):
            bad.append(f"(b) {label}: the traffic added programs")
        failed += bad + bad_ref
        for k, n in launches.items():
            if k != "routed" and n:
                launched[k] = launched.get(k, 0) + n
        if label == "fp32":
            fp32 = got
        del engine
    return launched, fp32, failed


def check_moe_spec_and_control(torch, model, prompts, fp32) -> tuple[int, list]:
    """Phase 4g (d): γ SPEC_GAMMA speculation with ``truncated_draft(model,
    DRAFT_DEPTH)`` (routed blocks 2 and 4) through the draft_decode and
    spec_verify graphs (warmed up under the sync debug mode "error", as
    (b)'s engines): streams equal the plain graph engine's (near
    ties by replay_gap), B4 = rounds x γ x draft depth. (e) the control:
    the same weights serving top-1 (the second choice dropped from the
    combine) must fail phase 4's stream check against the top-2 graph
    streams → (B4 launches, failures)."""
    from ddp_tpu_torch.models.lm import CausalLM, truncated_draft
    from ddp_tpu_torch.ops import decode as dec

    draft = truncated_draft(model, DRAFT_DEPTH)
    routed = [i + 1 for i in range(DRAFT_DEPTH) if draft.spec.routed(i)]
    sampling = {i: smp for i, (_, _, smp) in enumerate(REQUESTS) if smp}
    want, _ = spec_streams(torch, model, prompts, kv_dtype="fp32",
                           warmup=True)
    got, engine = spec_streams(torch, model, prompts, kv_dtype="fp32",
                               draft=draft, warmup=True, sync_error=True)
    launches, failed = _graph_launch_failures(dec, engine, "4g spec")
    parted, bad = _stream_failures(torch, model, prompts, got, want, "fp32",
                                   "4g spec", sampling)
    failed += bad
    log(f"[moe] (d) γ {SPEC_GAMMA}, truncated draft of depth {DRAFT_DEPTH} "
        f"(routed blocks {routed}): {len(got) - parted}/{len(got)} streams "
        f"identical to the plain graph engine's, {parted} parted at a near "
        f"tie; {engine.decode_steps} rounds, launches {launches}, "
        f"acceptance {engine.spec_acceptance_rate()}")
    if routed != [2, 4]:
        failed.append(f"(d) the draft routes blocks {routed}")
    b4 = launches["flash_decode_fp32"]
    del engine
    control = CausalLM.from_state(model.spec._replace(moe_top_k=1),
                                  model.state_dict())
    greedy = {i: c for i, c in enumerate(REQUESTS) if not c[2]}
    top1, _ = spec_streams(torch, control, prompts, kv_dtype="fp32",
                           cases=greedy, warmup=True)
    del control
    n_parted, bad = _stream_failures(torch, model, prompts, top1,
                                     {i: fp32[i] for i in greedy}, "fp32",
                                     "4g control top-1")
    log(f"[moe] (e) control, top-1 combine on the same weights: "
        f"{n_parted}/{len(greedy)} greedy streams part from top-2's, "
        f"{len(bad)} past a near tie (must be > 0)")
    if not bad:
        failed.append("(e) the stream check passes a top-1 combine")
    return b4, failed


def time_moe_steps(torch, model, card) -> dict:
    """Phase 4g (f), not gated: steady 8-lane fixed-lane fp32 decode step
    p50/p99 with graphs, the MoE model against phase 4's dense model (the
    same seed), in turns ABBA over GRAPH_STEPS steps; then the busy share
    of each from torch.profiler → readings."""
    from ddp_tpu_torch.models.lm import LMSpec, init_lm
    from ddp_tpu_torch.utils.metrics import StatSummary

    dense = init_lm(LMSpec(**FULL), seed=0)
    models = {"moe": model, "dense": dense}
    out = {"moe": [], "dense": []}
    for label in ("moe", "dense", "dense", "moe"):
        engine = steady_engine(torch, models[label])
        engine.step_latency = StatSummary()
        for _ in range(GRAPH_STEPS):
            engine.step()
        torch.cuda.synchronize()
        if engine.decode_steps < GRAPH_STEPS or engine.active != SLOTS:
            raise AssertionError("phase 4g (f): a timed step did not decode "
                                 "every lane")
        out[label].append({"p50_ms": engine.step_latency.percentile(50) * 1e3,
                           "p99_ms": engine.step_latency.percentile(99) * 1e3})
        del engine
    prof = {label: profile_steps(torch, m, steps=GRAPH_STEPS,
                                 label=f", {label}")
            for label, m in models.items()}
    del dense, models
    torch.cuda.empty_cache()
    log(f"[moe] (f) {card}; steady 8-lane fp32 decode step with graphs over "
        f"{GRAPH_STEPS} steps, turns ABBA (moe, dense, dense, moe): "
        + "; ".join(f"{k}: " + ", ".join(
            f"p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms" for r in v)
            for k, v in out.items())
        + "; torch.profiler busy share / kernel µs a step / kernels a step: "
        + ", ".join(f"{k} {v.get('busy')} / {v.get('kernel_us_per_step')} / "
                    f"{v.get('kernels_per_step')}" for k, v in prof.items()))
    return {"turns": out, "profile": prof}


def check_moe_serving(torch, card) -> dict:
    """Phase 4g: the MoE causal LM served at decode_moe's width from
    seeded weights → {"launches": graph launches by kernel, "b4_spec":
    (d)'s B4 launches, "timing": (f)}."""
    from ddp_tpu_torch.models.lm import LMSpec, init_lm

    t0 = time.perf_counter()
    spec = LMSpec(**MOE_FULL)
    model = init_lm(spec, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    log(f"[moe] {card}; {sum(p.numel() for p in model.parameters()) / 1e6:.1f}"
        f" M params, routed blocks "
        f"{[i + 1 for i in range(spec.depth) if spec.routed(i)]}")
    launched, fp32, failed = check_moe_runs(torch, model, prompts)
    b4, bad = check_moe_spec_and_control(torch, model, prompts, fp32)
    failed += bad
    timing = time_moe_steps(torch, model, card)
    log(f"[moe] phase 4g wall {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 4g: {failed}")
    return {"launches": launched, "b4_spec": b4, "timing": timing}


# ---- phase 4h: the MoE layer, index form against its plain version --------

# The layer at the training forward's width (d 1024, F 4096, 8 experts,
# top-2) at n 2048 tokens, where the one-hot plain version's [n, E, C]
# tensors fit: relative norm error of the output, the aux loss, the input
# gradient and each parameter's gradient. fp32 (TF32 off): the dispatch is
# a selection (bit for bit), the combine sums ≤ 2 products in another
# order; bf16: the combine's one rounding, as the einsum's.
MOE_LAYER = dict(n=2048, d=1024, mlp=4096, experts=8, top_k=2)
MOE_LAYER_TOL = {"fp32": 1e-5, "bf16": 1e-2}


def _moe_layer_run(torch, layer, x, dy, form, dt, wrong=False):
    """One forward and backward of ``layer`` (weights cast to ``dt``) →
    {"y", "aux", "x", <parameter>: gradient}; ``wrong``: a dispatch that
    ignores the capacity (every assignment kept, its slot modulo C)."""
    from ddp_tpu_torch.models import moe

    layer.zero_grad()
    xt = x.to(dt).detach().requires_grad_()
    w = layer.weights(dt)
    tokens = xt.reshape(-1, xt.shape[-1])
    r = moe.route(tokens, w["router.weight"], w["router.bias"],
                  num_experts=layer.num_experts, top_k=layer.top_k,
                  capacity_factor=layer.capacity_factor,
                  normalize_gates=layer.normalize_gates)
    if wrong:
        r = r._replace(kept=torch.ones_like(r.kept), slot=r.slot % r.capacity)
    y = moe.combine(moe._ffn(moe.dispatch(tokens, r, layer.num_experts, form),
                             w), r, form)
    ((y.float() * dy).sum() + r.aux).backward()
    out = {"y": y.detach().float(), "aux": r.aux.detach().reshape(1),
           "x": xt.grad.float(), "kept": float(r.kept.float().mean())}
    out.update((n, p.grad.float()) for n, p in layer.named_parameters())
    return out


def check_moe_layer(torch, device="cuda") -> dict:
    """Phase 4h: the MoE layer's index form (the models' path) against the
    one-hot plain version on the card, fp32 and bf16, at capacity factors
    0.5 (drops) and 2.0: the experts' input buffer bit for bit in fp32,
    the output, aux and every gradient within MOE_LAYER_TOL; a dispatch
    that ignores the capacity must fail at 0.5; then fwd+bwd times of
    both forms → readings."""
    from ddp_tpu_torch.models import moe

    c = MOE_LAYER
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(1, c["n"], c["d"], device=device, generator=gen)
    dy = torch.randn(1, c["n"], c["d"], device=device, generator=gen)
    failed, readings = [], {}
    layer = moe.MoEMLP(c["d"], c["mlp"], c["experts"], top_k=c["top_k"])
    state = {}
    moe.moe_init(state, "", np.random.default_rng(7), dim=c["d"],
                 mlp_dim=c["mlp"], num_experts=c["experts"])
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    layer = layer.to(device)
    for cf in (0.5, 2.0):
        layer.capacity_factor = cf
        for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            runs = {form: _moe_layer_run(torch, layer, x, dy, form, dt)
                    for form in moe.FORMS}
            if dname == "fp32":
                w = layer.weights()
                toks = x.reshape(-1, c["d"])
                r = moe.route(toks, w["router.weight"], w["router.bias"],
                              num_experts=c["experts"], top_k=c["top_k"],
                              capacity_factor=cf, normalize_gates=True)
                exact = torch.equal(moe.dispatch(toks, r, c["experts"]),
                                    moe.dispatch(toks, r, c["experts"],
                                                 "onehot"))
                if not exact:
                    failed.append(f"cf {cf}: the fp32 dispatch differs")
            want = runs["onehot"]
            errs = {k: float((runs["indexed"][k] - v).norm()
                             / v.norm().clamp_min(1e-30))
                    for k, v in want.items() if k != "kept"}
            worst = max(errs.items(), key=lambda kv: kv[1])
            tol = MOE_LAYER_TOL[dname]
            log(f"[moe] (4h) cf {cf} {dname}: kept {want['kept']:.4f}, "
                f"capacity {moe.expert_capacity(c['n'], c['experts'], c['top_k'], cf)}; "
                f"index vs one-hot rel errors y {errs['y']:.2e}, aux "
                f"{errs['aux']:.2e}, dx {errs['x']:.2e}, router "
                f"{errs['router.weight']:.2e}, wi {errs['wi']:.2e}, wo "
                f"{errs['wo']:.2e}; worst {worst[0]} {worst[1]:.2e} (limit "
                f"{tol})" + (f"; fp32 dispatch bit for bit: {exact}"
                             if dname == "fp32" else ""))
            if worst[1] > tol:
                failed.append(f"cf {cf} {dname}: {worst}")
            if cf == 0.5 and dname == "fp32":
                wrong = _moe_layer_run(torch, layer, x, dy, "indexed", dt,
                                       wrong=True)
                e = float((wrong["y"] - want["y"]).norm() / want["y"].norm())
                log(f"[moe] (4h) control, a dispatch that ignores the "
                    f"capacity: output rel error {e:.2e} (must exceed {tol})")
                if e <= tol:
                    failed.append("the check passes a dispatch that ignores "
                                  "the capacity")
            if cf == 2.0:
                for form in moe.FORMS:
                    readings[f"{dname}_{form}_ms"] = _median_ms(
                        torch, lambda f=form: _moe_layer_run(
                            torch, layer, x, dy, f, dt), n=3, reps=3)
    del layer
    log(f"[moe] (4h) fwd+bwd ms at n {c['n']}, cf 2.0 (route, dispatch, "
        f"FFN, combine, backward): {readings}")
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 4h: {failed}")
    return readings


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
    """Training flops per token. A dense MHA model: bench.py
    run_lm_bench's estimate, 6·N (tied embedding counted once) + causal
    attention 3.5 × 2 matmuls × T/2 keys × d × depth. Under GQA or MoE:
    the structural count of ``ddp_tpu/obs/goodput.py:160-252`` (copied):
    3 × (the kv-narrowed qkv, the projection, the two causal attention
    matmuls, and the MLP — in a routed block top_k experts' worth plus
    the router: the ACTIVE flops, not the capacity buffer's) + the tied
    head."""
    d, T = spec.d_model, spec.total_len
    if not (spec.num_experts or spec.num_kv_heads):
        n_params = spec.depth * 12 * d * d + spec.vocab_size * d
        return 6 * n_params + 3.5 * 2 * 2 * (T / 2) * d * spec.depth
    fwd = 0.0
    for i in range(spec.depth):
        qkv = 2.0 * d * d * (spec.num_heads + 2 * spec.kv_heads) / spec.num_heads
        attn = 2.0 * 2.0 * (T / 2) * d
        mlp = 2.0 * 2.0 * spec.mlp_ratio * d * d
        if spec.routed(i):
            mlp = spec.moe_top_k * mlp + 2.0 * d * spec.num_experts
        fwd += qkv + 2.0 * d * d + attn + mlp
    return 3.0 * (fwd + 2.0 * d * spec.vocab_size)


def _zero(counts: dict) -> None:
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def fixed_routing(torch, record: list, flips: list):
    """While open, every routed block's ``models.moe.route`` call is
    recorded in ``record`` (when ``record`` is empty at entry), or, in a
    later block of the same calls, takes the recorded decisions (each
    token's experts, slots, and which were kept) of the call at its
    position, its gates and aux recomputed from its own router; the
    decisions it would have taken otherwise that differ are counted into
    ``flips``. A step check compares attention paths: a token whose top-2
    gates are a near tie routes to another expert on a 1e-3 change of its
    input, which moves that expert's gradient by the token's share, not
    by an attention error. Nothing is recorded for a dense model."""
    from ddp_tpu_torch.models import moe

    real, replay, calls = moe.route, bool(record), [0]

    def route(tokens, router_weight, router_bias, *, num_experts, top_k,
              capacity_factor, normalize_gates):
        r = real(tokens, router_weight, router_bias, num_experts=num_experts,
                 top_k=top_k, capacity_factor=capacity_factor,
                 normalize_gates=normalize_gates)
        if not replay:
            record.append(r)
            return r
        old = record[calls[0]]
        calls[0] += 1
        flips.append(int((r.expert != old.expert).sum()))
        gates = torch.softmax(torch.nn.functional.linear(
            tokens.float(), router_weight.float(), router_bias.float()), -1)
        gate = torch.stack([gates.gather(-1, e[:, None])[:, 0]
                            for e in old.expert]) * old.kept
        if normalize_gates:
            gate = gate / torch.clamp(gate.sum(0, keepdim=True), min=1e-9)
        first = (old.expert[0][:, None]
                 == torch.arange(num_experts, device=tokens.device)).float()
        aux = num_experts * torch.sum(gates.mean(0) * first.mean(0))
        return old._replace(gates=gate, aux=aux)

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


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

    drop_tile = _drop_key_grad(torch, slice(512, 576))

    def dropped_dk(q, k, v, causal):
        return fl.attention_with_lse_reference(q, drop_tile(k), v, causal)

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
    routes, flips = [], []
    with fixed_routing(torch, routes, flips):
        kernel = _step_grads(torch, trainer, toks, None)
    _zero(fl.flash_attention.launches)
    with fixed_routing(torch, routes, flips):
        plain = _step_grads(torch, trainer, toks,
                            fl.attention_with_lse_reference)
    e = _grad_errors(kernel, plain)
    log(f"[train] {dname} one step, kernel vs plain attention (batch "
        f"{batch}): loss {kernel[0]:.6f} vs {plain[0]:.6f}; {_errors_text(e)} "
        f"(tolerances {tol})"
        + (f"; routing held to the kernel step's, routed blocks' own "
           f"choices would differ at {flips} of {toks.numel() * 2} "
           f"(token, k) per block" if routes else ""))
    failed = [] if _within(e, tol) else ["the kernel step disagrees"]
    del kernel
    with fixed_routing(torch, routes, []):
        dropped = _step_grads(torch, trainer, toks, dropped_dk)
    e = _grad_errors(dropped, plain)
    del dropped
    log(f"[train] {dname} control, dK tile dropped vs plain: "
        f"{_errors_text(e)}")
    if _within(e, tol):
        failed.append("the check passes a B3 that drops a dK tile")
    if dname == "bf16":
        with fixed_routing(torch, routes, []):
            low = _step_grads(torch, trainer, toks, low_precision)
        e = _grad_errors(low, plain)
        del low
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


def check_training(torch, ckdirs: dict) -> dict:
    """Phase 5: ``python -m ddp_tpu_torch.train``'s own main() at the
    full width (bf16), then its fp32 variant at depth 2, each with
    ``--checkpoint_dir ckdirs[dtype]`` (phase 8a checks what they write,
    and the bf16 run's resume) → the launch counts of each run, by
    counter name."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train.trainer import main as train_main

    launches = fl.flash_attention.launches
    counted = {}
    for args, dname in ((TRAIN_ARGS, "bf16"), (TRAIN_FP32_ARGS, "fp32")):
        args = args + ["--checkpoint_dir", ckdirs[dname]]
        log(f"[train] python -m ddp_tpu_torch.train {' '.join(args)}")
        _zero(launches)
        fl.flash_attention.plain_routed = 0
        with _timed_saves() as save_s:
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
        check_lm_checkpoint(torch, trainer, ckdirs[dname], dname, save_s)
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
    check_lm_resume(torch, TRAIN_ARGS + ["--checkpoint_dir", ckdirs["bf16"]])
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


def check_routed_training(torch, ckdir: str) -> None:
    """Phase 5a: ``python -m ddp_tpu_torch.train`` at head dim 24, which
    B1-B3 do not take: every attention block must take the plain block on
    the card (counted > 0), launch no kernel, and give finite losses."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train.trainer import main as train_main

    args = TRAIN_ROUTED_ARGS + ["--checkpoint_dir", ckdir]
    log(f"[train] python -m ddp_tpu_torch.train {' '.join(args)}")
    _zero(fl.flash_attention.launches)
    fl.flash_attention.plain_routed = 0
    trainer = train_main(args)
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


# ---- phase 8: from training to serving -----------------------------------

# Phase 8's traffic comes from the training distribution (synthetic_tokens
# at PHASE8_SEED, vocab 8192): phase 4c's shape, a 96-token prefix (the
# first sequence's start) and a 16-token tail of each other sequence.
PHASE8_SEED = 0
LM_SLOTS = 8
# POST /reload lands once this many requests are in flight; while it
# verifies and loads, more requests arrive, one every RELOAD_EXTRA_GAP_S
# (at most RELOAD_EXTRA), and once admission has paused RELOAD_QUEUED
# more, which wait in the queue for the swap.
RELOAD_IN_FLIGHT, RELOAD_EXTRA, RELOAD_EXTRA_GAP_S = 8, 200, 0.1
RELOAD_QUEUED = 8
# 8d: requests in flight when SIGTERM drains the server.
DRAIN_REQUESTS, DRAIN_NEW = 8, 128


@contextlib.contextmanager
def _timed_saves():
    """Seconds of each ``CheckpointManager.save`` inside the block."""
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    real, seconds = CheckpointManager.save, []

    def save(self, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    CheckpointManager.save = save
    try:
        yield seconds
    finally:
        CheckpointManager.save = real


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def check_lm_checkpoint(torch, trainer, ckdir, dname, save_s) -> None:
    """Phase 8a, after a phase-5 run: one verified epoch directory per
    epoch and the lm_spec.json sidecar, and the served parameters
    (``restore_for_inference``, memory-mapped) equal to the trainer's bit
    for bit."""
    from ddp_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_lm_spec_fields,
    )

    mgr = CheckpointManager(ckdir)
    epochs = list(range(trainer.config.epochs))
    t0 = time.perf_counter()
    problems = {e: mgr.verify_epoch(e) for e in mgr.all_epochs()}
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, epoch = mgr.restore_for_inference()
    differ = [k for k, v in trainer.model.state_dict().items()
              if not torch.equal(state[k], v.cpu())]
    restore_s = time.perf_counter() - t0
    sidecar = load_lm_spec_fields(ckdir)
    log(f"[ckpt] {dname}: epochs {mgr.all_epochs()} in {ckdir} "
        f"({_dir_bytes(ckdir) / 1e9:.3f} GB), saves "
        + ", ".join(f"{s:.2f}" for s in save_s)
        + f" s, manifests verified in {verify_s:.2f} s ({problems}), "
        f"restore_for_inference epoch {epoch} read and compared in "
        f"{restore_s:.2f} s, {len(state)} tensors, {len(differ)} differ; "
        f"sidecar {sidecar}")
    failed = []
    if mgr.all_epochs() != epochs or any(p != [] for p in problems.values()):
        failed.append(f"epochs {mgr.all_epochs()} / manifests {problems}")
    if epoch != epochs[-1] or differ or set(state) != set(
            trainer.model.state_dict()):
        failed.append(f"restore_for_inference epoch {epoch} differs: "
                      f"{differ[:5]}")
    if sidecar != trainer.spec._asdict():
        failed.append(f"sidecar {sidecar} != {trainer.spec._asdict()}")
    if failed:
        raise AssertionError(f"phase 8a {dname}: {failed}")


def check_lm_resume(torch, args) -> None:
    """Phase 8a: the bf16 command again with ``--epochs 3`` resumes from
    epoch 1 (its log line), trains epoch 2 alone, and the parameters and
    Adam moments it restored equal epoch 1's saved ones bit for bit."""
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.trainer import main as train_main

    args = list(args)
    args[args.index("--epochs") + 1] = "3"
    mgr = CheckpointManager(args[args.index("--checkpoint_dir") + 1])
    real, restored = CheckpointManager.restore, []

    def restore(self, state, epoch=None):
        out = real(self, state, epoch)
        opt = state.optimizer.state_dict()  # copies on the card only
        restored.append((out, {
            k: [t.clone() for t in v] if isinstance(v, list) else v
            for k, v in opt.items()}, {
            k: v.cpu().clone() for k, v in state.model.state_dict().items()}))
        return out

    log(f"[ckpt] python -m ddp_tpu_torch.train {' '.join(args)}")
    tee = _Tee(sys.stdout)
    CheckpointManager.restore = restore
    try:
        with contextlib.redirect_stdout(tee):
            trainer = train_main(args)
    finally:
        CheckpointManager.restore = real
    torch.cuda.synchronize()
    epoch, opt, params = restored[0]
    blob = mgr.read(1)
    moments = [(k, i) for k in ("mu", "nu")
               for i, (a, b) in enumerate(zip(opt[k], blob["opt_state"][k]))
               if not torch.equal(a, b)]
    differ = [k for k, v in params.items()
              if not torch.equal(v, blob["params"][k])]
    lines = tee.text().splitlines()
    log(f"[ckpt] resumed run: first line {lines[0]!r}; restored epoch "
        f"{epoch}, count {opt['count']} (saved {blob['opt_state']['count']}), "
        f"{len(moments)} moment buffers and {len(differ)} parameters differ "
        f"from the saved ones; trained epochs "
        f"{[h['epoch'] for h in trainer.history]}; epochs on disk "
        f"{mgr.all_epochs()}")
    if (lines[0] != "Resumed from checkpoint epoch 1" or epoch != 1
            or moments or differ or opt["count"] != blob["opt_state"]["count"]
            or [h["epoch"] for h in trainer.history] != [3]
            or mgr.all_epochs() != [0, 1, 2]):
        raise AssertionError("phase 8a: the bf16 run did not resume epoch "
                             "1's state bit for bit")
    del trainer, blob, opt, params
    torch.cuda.empty_cache()


def lm_prompts(vocab: int) -> list[list[int]]:
    """Phase 8's prefix traffic: 1 + PREFIX_BURST prompts of one 96-token
    prefix and a 16-token tail each, from the training distribution."""
    from ddp_tpu_torch.data.sequences import synthetic_tokens

    toks = synthetic_tokens(2 + PREFIX_BURST, total_len=PREFIX_TOKENS,
                            vocab_size=vocab, seed=PHASE8_SEED)
    return [toks[0].tolist() + toks[1 + i, :TAIL_TOKENS].tolist()
            for i in range(1 + PREFIX_BURST)]


def _post_status(url: str, route: str, body: dict):
    """POST → (status, headers, payload), whatever the status."""
    import urllib.error

    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _concurrent(fn, items, during=None) -> dict:
    """``fn(item)`` for every item in its own thread, ``during()`` in this
    one while they run → {index: result}; raises on any error."""
    out, errors = {}, []

    def run(i, item):
        try:
            out[i] = fn(item)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i, x))
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors[:5]}")
    return out


def prefix_traffic(url, prompts, during=None) -> dict:
    """The seed request alone, then the burst concurrently (``during()``
    runs while it does) → {index: reply}."""
    def ask(p):
        return _post(url, {"prompt_tokens": p, "max_new_tokens": PREFIX_NEW})

    first = ask(prompts[0])
    burst = _concurrent(ask, prompts[1:], during)
    return {0: first, **{i + 1: r for i, r in burst.items()}}


def serve_main_with(torch, argv, traffic, *, on_step=None):
    """``python -m ddp_tpu_torch.serve``'s own main(argv) in this thread
    (it serves until SIGTERM) while ``traffic(url, made, stop)`` runs in
    a client thread: ``made`` lists the engines main() built, in order,
    ``stop()`` sends the one SIGTERM (sent after ``traffic`` returns, if
    it did not). The decode launch counters are set to 0 when the server
    first answers, after main()'s warmup (which captures the step graphs,
    running each program once) and before ``traffic``. ``on_step(engine)``
    runs after every engine step (in the engine's thread, under the
    server's lock) → (made, the lines main() printed)."""
    import io
    import os
    import signal

    import ddp_tpu_torch.serve.engine as engine_mod
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.__main__ import main as serve_main

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    base = engine_mod.ServeEngine
    made, errors, signalled = [], [], []
    sending, over = threading.Lock(), threading.Event()

    class Seen(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def step(self):
            out = super().step()
            if on_step is not None:
                on_step(self)
            return out

    def stop():
        # Never after main() returned: its SIGTERM handler is gone then.
        with sending:
            if not signalled and not over.is_set():
                signalled.append(True)
                os.kill(os.getpid(), signal.SIGTERM)

    def client():
        try:
            deadline = time.perf_counter() + 600
            while True:
                try:
                    _get(url, "/healthz")
                    break
                except OSError:
                    if over.is_set() or time.perf_counter() > deadline:
                        raise
                    time.sleep(0.2)
            _zero_decode_counters(dec)
            traffic(url, made, stop)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"traffic: {type(e).__name__}: {e}")
        finally:
            stop()

    argv = argv + ["--port", str(port)] + SERVE_DEVICE_ARGS
    old = signal.getsignal(signal.SIGTERM)
    printed = io.StringIO()
    engine_mod.ServeEngine = Seen
    thread = threading.Thread(target=client)
    thread.start()
    try:
        with contextlib.redirect_stdout(printed):
            serve_main(argv)
    finally:
        with sending:
            over.set()
        engine_mod.ServeEngine = base
        signal.signal(signal.SIGTERM, old)
        thread.join(timeout=900)
    torch.cuda.synchronize()
    lines = printed.getvalue().strip().splitlines()
    log(f"[serve] main({' '.join(argv)}) printed {' '.join(lines)}")
    if errors or thread.is_alive():
        raise AssertionError("; ".join(errors) or "the client did not finish")
    return made, lines


def _lm_launches(dec) -> tuple[dict, dict, int]:
    return (dict(dec.flash_decode_attention.launches),
            dict(dec.flash_decode_paged_attention.launches),
            dec.flash_decode_attention.plain_routed
            + dec.flash_decode_paged_attention.plain_routed)


def _restored(torch, directory, epoch=None):
    """(model on the card, its state, epoch) from a checkpoint."""
    from ddp_tpu_torch.models.lm import CausalLM
    from ddp_tpu_torch.train.checkpoint import (
        CheckpointManager,
        derive_spec_with_sidecar,
    )

    state, epoch = CheckpointManager(directory).restore_for_inference(epoch)
    spec = derive_spec_with_sidecar(directory, state, num_heads_fallback=1)
    return CausalLM.from_state(spec, state), state, epoch


def paged_streams(torch, model, prompts, *, watch=None, engine=None,
                  **engine_kw):
    """Phase 8's prefix traffic in-process on a paged engine (page
    SERVE_PAGE, LM_SLOTS lanes, main()'s defaults, ``engine_kw``): the
    seed request alone, then the burst at once; ``watch`` is installed
    for the burst only → (completions in prompt order, engine)."""
    from ddp_tpu_torch.serve.engine import ServeEngine

    engine = engine or ServeEngine(model, slots=LM_SLOTS,
                                   page_size=SERVE_PAGE,
                                   max_queue=len(prompts), **engine_kw)
    rids = [engine.submit(prompts[0], PREFIX_NEW).request.rid]
    engine.run()
    with (watch(engine) if watch else contextlib.nullcontext()):
        rids += [engine.submit(p, PREFIX_NEW).request.rid
                 for p in prompts[1:]]
        engine.run()
    torch.cuda.synchronize()
    done = [engine.pop_result(r) for r in rids]
    if any(c.status != "complete" for c in done):
        raise AssertionError("phase 8: an in-process request did not "
                             "complete")
    return done, engine


@contextlib.contextmanager
def first_logits(engine, seen: dict):
    """Record into ``seen``, by request id, the logits each request's
    first token is drawn from (its final prefill chunk's). A Python hook
    at each chunk call: the engine must run its programs eagerly
    (``cuda_graphs=False``)."""
    import ddp_tpu_torch.models.generate as gen
    import ddp_tpu_torch.serve.engine as engine_mod

    real_chunk = engine_mod.prefill_chunk_device
    real_sample = gen.sample_slot_tokens

    def chunk(*a, **kw):
        slot, final = int(a[7]), bool(a[11])
        if not final or a[0] is not engine.model:
            return real_chunk(*a, **kw)

        def sample(logits, *sa, **skw):
            seen[engine._slots[slot].request.rid] = logits.detach().clone()
            return real_sample(logits, *sa, **skw)

        gen.sample_slot_tokens = sample
        try:
            return real_chunk(*a, **kw)
        finally:
            gen.sample_slot_tokens = real_sample

    engine_mod.prefill_chunk_device = chunk
    try:
        yield seen
    finally:
        engine_mod.prefill_chunk_device = real_chunk


def check_swap_in_process(torch, state0, state1, model1, prompts, fresh):
    """Phase 8b's bit check and its control, in-process where the
    batching is the same on both sides: a paged engine on epoch 0 serves
    the traffic, takes epoch 1 through ``install_params`` with the flush
    a new version gets (``invalidate_prefix=True``, what POST /reload
    does), or without it (the control), and serves the traffic again. Its
    burst (every request a 96-token prefix hit) is held against a fresh
    engine's on epoch 1: the first logits bit for bit, and the streams.
    The flushed swap must pass, the control must fail → failures."""
    from ddp_tpu_torch.models.lm import CausalLM

    want_done, want_bits = fresh
    failed = []
    for flush in (True, False):
        model = CausalLM.from_state(model1.spec, state0, model1.device)
        _, engine = paged_streams(torch, model, prompts, cuda_graphs=False)
        engine.install_params(state1, model_version="epoch1",
                              invalidate_prefix=flush)
        bits: dict = {}
        done, _ = paged_streams(torch, model, prompts, engine=engine,
                                watch=lambda e: first_logits(e, bits))
        same_bits = sum(torch.equal(bits[c.rid], want_bits[w.rid])
                        for c, w in zip(done[1:], want_done[1:]))
        same_streams = sum(c.tokens == w.tokens
                           for c, w in zip(done, want_done))
        hits = [c.prefix_hit_tokens for c in done]
        label = "flushed swap" if flush else "control, no flush"
        log(f"[swap] in-process {label}: first logits bitwise equal to the "
            f"fresh engine's for {same_bits}/{len(done) - 1} burst requests, "
            f"streams equal for {same_streams}/{len(done)}; prefix hits "
            f"{hits[0]} (first request after the swap), burst "
            f"{min(hits[1:])}-{max(hits[1:])}")
        passes = same_bits == len(done) - 1 and same_streams == len(done)
        if flush and (not passes or hits[0] != 0):
            failed.append("the flushed swap parts from a fresh engine")
        if not flush and passes:
            failed.append("the check passes a stale prefix")
        del engine, model
        torch.cuda.empty_cache()
    return failed


def _swap_traffic(prompts, bf16_dir, fp32_dir, empty_dir, out):
    """Phase 8b's client: run A at epoch 0 with POST /reload of epoch 1
    while RELOAD_IN_FLIGHT requests are in flight (and the extra ones
    arriving until it pauses admission, then RELOAD_QUEUED more:
    ``out["A_extra"]``, by arrival, of (prompt index, reply, sent after
    the pause)), run B, the same reload again, run C, then the three
    rejected reloads, each followed by one request."""
    import os

    def traffic(url, made, stop):
        def reload_when_busy():
            # The engine's own count, read without its lock: /healthz
            # waits for the lock, and a burst can pass between two reads.
            deadline = time.perf_counter() + 120
            while ((busy := made[0].active) < RELOAD_IN_FLIGHT
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            out["in_flight"] = busy
            reload = threading.Thread(target=lambda: out.__setitem__(
                "reload", _post_status(url, "/reload", {
                    "checkpoint_dir": bf16_dir, "epoch": 1})))
            reload.start()
            extra, threads = {}, []

            def ask(k, paused):
                i = 1 + k % PREFIX_BURST
                extra[k] = (i, _post(url, {"prompt_tokens": prompts[i],
                                           "max_new_tokens": PREFIX_NEW}),
                            paused)

            def send(paused=False):
                threads.append(threading.Thread(
                    target=ask, args=(len(threads), paused)))
                threads[-1].start()

            next_send = 0.0
            while reload.is_alive() and not made[0]._admission_paused:
                if (time.perf_counter() >= next_send
                        and len(threads) < RELOAD_EXTRA):
                    send()
                    next_send = time.perf_counter() + RELOAD_EXTRA_GAP_S
                time.sleep(0.001)
            # Admission is paused (the server sets the flag right after
            # the load): these wait in the queue for the swap.
            for _ in range(RELOAD_QUEUED if reload.is_alive() else 0):
                send(paused=True)
            for t in [reload, *threads]:
                t.join(timeout=900)
            out["A_extra"] = [extra[k] for k in sorted(extra)]
            if len(extra) != len(threads):
                raise AssertionError("an extra request of run A failed")

        out["A"] = prefix_traffic(url, prompts, reload_when_busy)
        out["B"] = prefix_traffic(url, prompts)
        out["again"] = _post_status(url, "/reload",
                                    {"checkpoint_dir": bf16_dir, "epoch": 1})
        out["C"] = prefix_traffic(url, prompts)
        torn = os.path.join(fp32_dir, "epoch_0", "state.pt")
        for reason, directory in (("spec_skew", fp32_dir),
                                  ("manifest_missing", empty_dir),
                                  ("crc_mismatch", fp32_dir)):
            if reason == "crc_mismatch":
                _flip_byte(torn)
            try:
                out[reason] = _post_status(url, "/reload",
                                           {"checkpoint_dir": directory})
            finally:
                if reason == "crc_mismatch":
                    _flip_byte(torn)
            out[reason + "_next"] = _post(url, {
                "prompt_tokens": prompts[0], "max_new_tokens": PREFIX_NEW})

    return traffic


def _flip_byte(path: str, offset: int = -100) -> None:
    with open(path, "r+b") as f:
        f.seek(offset, 2)
        b = f.read(1)
        f.seek(offset, 2)
        f.write(bytes([b[0] ^ 0xFF]))


def _parts(torch, model, prompts, got: dict, want: list, label) -> list:
    """Streams ``got`` (index → tokens) against ``want`` (a list): equal,
    or parted only at a near tie (phase 4's rule) → failures."""
    failed = []
    for i, tokens in got.items():
        if tokens == want[i]:
            continue
        j = next((n for n, (x, y) in enumerate(zip(tokens, want[i]))
                  if x != y), None)
        if j is None or j == 0:
            failed.append(f"{label} request {i} parts at token {j}")
            continue
        gap = replay_gap(torch, model, prompts[i], want[i], j, "fp32")
        log(f"[swap] {label} request {i}: streams part at token {j}; top-2 "
            f"gap {gap:.3e}")
        if gap >= DIVERGENCE_GAP:
            failed.append(f"{label} request {i} diverged at gap {gap}")
    return failed


def check_lm_swap(torch, dirs, empty_dir) -> dict:
    """Phase 8b: serving the trained checkpoint through main() with
    --page_size 16, the hot-swap under load and its controls → readings
    (B4p's launches, the reload's seconds)."""
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.lifecycle import model_version_token

    bf16_dir, fp32_dir = dirs["bf16"], dirs["fp32"]
    model0, state0, _ = _restored(torch, bf16_dir, 0)
    model1, state1, _ = _restored(torch, bf16_dir, 1)
    prompts = lm_prompts(model0.spec.vocab_size)
    out: dict = {}
    argv = ["--checkpoint_dir", bf16_dir, "--epoch", "0", "--page_size",
            str(SERVE_PAGE), "--slots", str(LM_SLOTS)]
    _zero_decode_counters(dec)
    t0 = time.perf_counter()
    made, _ = serve_main_with(
        torch, argv, _swap_traffic(prompts, bf16_dir, fp32_dir, empty_dir,
                                   out))
    wall = time.perf_counter() - t0
    flat, paged, routed = _lm_launches(dec)
    engine = made[0]
    v0, v1 = (model_version_token(bf16_dir, e) for e in (0, 1))
    fixed = {v0: fixed_lane_streams(torch, model0, prompts, kv_dtype="fp32"),
             v1: fixed_lane_streams(torch, model1, prompts, kv_dtype="fp32")}
    bits: dict = {}
    fresh_done, _ = paged_streams(torch, model1, prompts, cuda_graphs=False,
                                  watch=lambda e: first_logits(e, bits))
    fresh = [c.tokens for c in fresh_done]
    failed = []
    status, _, reload = out["reload"]
    # Run A: (prompt index, reply), the burst and the extra requests.
    a = list(out["A"].items()) + [(i, r) for i, r, _ in out["A_extra"]]
    queued = [r for _, r, paused in out["A_extra"] if paused]
    after = [r for _, r in a if r.get("model_version") == v1]
    # The first request bound after the swap: run A's first under epoch 1
    # (rids rise in submission order, and the queue binds FIFO), else run
    # B's seed request.
    first_after = (min(after, key=lambda r: r["rid"]) if after
                   else out["B"][0])
    log(f"[swap] POST /reload epoch 1 with {out['in_flight']} requests in "
        f"flight and {len(out['A_extra'])} more arriving until it answered: "
        f"{status} {reload}; run A: {len(a)} requests, "
        f"{sum(r['status'] == 'complete' for _, r in a)} complete, "
        f"{len(a) - len(after)} under {v0}, {len(after)} under {v1} "
        f"({len(queued)} sent after the pause, "
        f"{sum(r.get('model_version') == v1 for r in queued)} of them under "
        f"{v1}); the first bound after the swap (rid {first_after['rid']}) "
        f"hit {first_after['prefix_hit_tokens']} prefix tokens")
    if (status != 200 or not reload["invalidated_prefix"]
            or reload["model_version"] != v1 or reload["previous_version"] != v0
            or out["in_flight"] < RELOAD_IN_FLIGHT):
        failed.append(f"reload {status} {reload}, in flight {out['in_flight']}")
    if any(r["status"] != "complete" or len(r["tokens"]) != PREFIX_NEW
           or r.get("model_version") not in fixed for _, r in a):
        failed.append("run A: a request did not complete under a version")
    if first_after["prefix_hit_tokens"] != 0:
        failed.append("the first request after the swap hit the flushed index")
    if not queued or any(r.get("model_version") != v1 for r in queued):
        failed.append(f"requests queued at the barrier: {len(queued)}, not "
                      f"all under {v1}")
    for i, r in a:
        v = r["model_version"]
        failed += _parts(torch, model0 if v == v0 else model1, prompts,
                         {i: r["tokens"]}, fixed[v], f"run A {v}")
    for run in ("B", "C"):
        replies = out[run]
        if any(r.get("model_version") != v1 for r in replies.values()):
            failed.append(f"run {run} served another version")
        failed += _parts(torch, model1, prompts,
                         {i: r["tokens"] for i, r in replies.items()}, fresh,
                         f"run {run} vs fresh")
    hits_c = [out["C"][i]["prefix_hit_tokens"] for i in sorted(out["C"])]
    status, _, again = out["again"]
    log(f"[swap] runs B and C against a fresh engine on epoch 1: "
        f"{sum(out['B'][i]['tokens'] == fresh[i] for i in out['B'])} and "
        f"{sum(out['C'][i]['tokens'] == fresh[i] for i in out['C'])} of "
        f"{len(prompts)} streams identical; the same reload again: {status} "
        f"{again}; run C prefix hits {min(hits_c)}-{max(hits_c)}")
    if status != 200 or again["invalidated_prefix"] or min(hits_c) == 0:
        failed.append(f"the same-version reload: {status} {again}, hits "
                      f"{hits_c}")
    for reason in ("spec_skew", "manifest_missing", "crc_mismatch"):
        status, _, payload = out[reason]
        nxt = out[reason + "_next"]
        log(f"[swap] control POST /reload → {status} {payload['error']}: "
            f"{payload.get('detail', '')[:160]}; next stream unchanged: "
            f"{nxt['tokens'] == out['C'][0]['tokens']}")
        if (status, payload["error"]) != (409, reason) or (
                nxt["tokens"] != out["C"][0]["tokens"]
                or nxt["model_version"] != v1):
            failed.append(f"control {reason}: {status} {payload}")
    steps, depth = engine.decode_steps, model0.spec.depth
    name = "flash_decode_paged_fp32"
    log(f"[swap] launches {paged} (decode steps x depth = {steps * depth}), "
        f"fixed-lane {flat}, routed {routed}; stats lifecycle "
        f"{engine.stats().get('lifecycle')}; wall {wall:.2f} s")
    if (paged[name] != steps * depth or sum(paged.values()) != paged[name]
            or any(flat.values()) or routed):
        failed.append(f"launches {paged} {flat}, routed {routed}")
    failed += check_swap_in_process(torch, state0, state1, model1, prompts,
                                    (fresh_done, bits))
    if failed:
        raise AssertionError(f"phase 8b: {failed}")
    return {"b4p": paged[name], "epoch1_streams": fresh,
            "reload": reload, "model1": model1}


def _spec_traffic(torch, prompts, cases, out):
    """Phase 8c-8d's client: ``cases`` (phase 4d's requests) at once
    (speculative, the target from the bf16 checkpoint, the trained
    depth-2 draft), the named model, an unknown one, then SIGTERM with
    DRAIN_REQUESTS in flight and a request during the drain."""
    def traffic(url, made, stop):
        engine, named = made
        out["split"] = _time_round(torch, engine)

        def ask(i):
            _, n_new, sampling = cases[i]
            return _post(url, {"prompt_tokens": prompts[i],
                               "max_new_tokens": n_new, **sampling})

        t0 = time.perf_counter()
        out["spec"] = _concurrent(ask, range(len(cases)))
        out["spec_wall"] = time.perf_counter() - t0
        before = (engine.tokens_emitted_total, named.tokens_emitted_total)
        out["named"] = _post(url, {"prompt_tokens": prompts[0],
                                   "max_new_tokens": PREFIX_NEW,
                                   "model": "draft"})
        out["named_counts"] = (before, (engine.tokens_emitted_total,
                                        named.tokens_emitted_total))
        out["nope"] = _post_status(url, "/generate", {
            "prompt_tokens": prompts[0], "max_new_tokens": 2,
            "model": "nope"})

        def drain():
            deadline = time.perf_counter() + 120
            while ((busy := engine.active) < DRAIN_REQUESTS
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            out["drain_in_flight"] = busy
            stop()
            while not _get(url, "/healthz")["draining"]:
                time.sleep(0.002)
            out["refused"] = _post_status(url, "/generate", {
                "prompt_tokens": prompts[0], "max_new_tokens": 2})

        out["drained"] = _concurrent(
            lambda i: _post(url, {"prompt_tokens": prompts[i],
                                  "max_new_tokens": out["drain_new"][i]}),
            range(DRAIN_REQUESTS), drain)

    return traffic


def check_trained_draft(torch, card, dirs) -> dict:
    """Phases 8c and 8d on one main() run: --checkpoint_dir (the bf16
    run's latest epoch) with --draft_checkpoint_dir (the fp32 depth-2
    run) at γ SPEC_GAMMA, fixed-lane fp32 KV, and --model draft=<the
    depth-2 directory> → readings (B4's launches, acceptance)."""
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.engine import ServeEngine

    target, _, _ = _restored(torch, dirs["bf16"])
    draft, _, _ = _restored(torch, dirs["fp32"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, target.spec.vocab_size, n).tolist()
               for n, _, _ in REQUESTS]
    sampling = {i: s for i, (_, _, s) in enumerate(REQUESTS) if s}
    # The speculative admission ceiling (total_len - (γ - 1)) caps the
    # budgets, as spec_requests() does at phase 4's length.
    ceiling = target.spec.total_len - (SPEC_GAMMA - 1)
    cases = {i: (n, min(new, ceiling - n), s)
             for i, (n, new, s) in enumerate(REQUESTS)}
    drain_new = [min(DRAIN_NEW, ceiling - len(p)) for p in prompts]
    out: dict = {"drain_new": drain_new}
    argv = ["--checkpoint_dir", dirs["bf16"], "--draft_checkpoint_dir",
            dirs["fp32"], "--spec_tokens", str(SPEC_GAMMA), "--slots",
            str(LM_SLOTS), "--model", f"draft={dirs['fp32']}"]
    _zero_decode_counters(dec)
    made, lines = serve_main_with(torch, argv,
                                  _spec_traffic(torch, prompts, cases, out))
    flat, paged, routed = _lm_launches(dec)
    engine, named = made
    failed = []
    # 8c: the streams against the plain engine on the same weights.
    plain = ServeEngine(target, slots=LM_SLOTS, max_queue=len(prompts))
    rids = {i: plain.submit(prompts[i], n, **s).request.rid
            for i, (_, n, s) in cases.items()}
    plain.run()
    want = {i: plain.pop_result(r).tokens for i, r in rids.items()}
    got = {i: r["tokens"] for i, r in out["spec"].items()}
    parted, bad = _stream_failures(torch, target, prompts, got, want, "fp32",
                                   "trained draft", sampling)
    failed += bad
    depth = draft.spec.depth
    want_b4 = (engine.decode_steps * SPEC_GAMMA * depth
               + named.decode_steps * named.spec.depth)
    tokens = sum(len(t) for t in got.values())
    split = {k: float(np.median([a.elapsed_time(b) for a, b in v[8:]]))
             if len(v) > 8 else None for k, v in out["split"].items()}
    log(f"[draft] {card}")
    log(f"[draft] target {dirs['bf16']} (depth {target.spec.depth}), trained "
        f"draft {dirs['fp32']} (depth {depth}), γ {SPEC_GAMMA}: "
        f"{len(got)} streams, {len(got) - parted} identical to the plain "
        f"engine's, {parted} parted at a near tie; acceptance "
        f"{engine.spec_acceptance_rate()}, {engine.decode_steps} target "
        f"steps, {tokens / max(1, engine.decode_steps):.3f} tokens a target "
        f"step, {tokens} tokens in {out['spec_wall']:.3f} s = "
        f"{tokens / out['spec_wall']:.1f} tokens/s; steady round: "
        f"{SPEC_GAMMA} draft steps {split['draft_ms']} ms, verify "
        f"{split['verify_ms']} ms (CUDA events, median)")
    log(f"[draft] launches {flat} (target rounds x γ x draft depth + the "
        f"named engine's steps x depth = {want_b4}), paged {paged}, routed "
        f"{routed}")
    if (engine.draft_decode_attn != "flash" or flat["flash_decode_fp32"]
            != want_b4 or flat["flash_decode_int8"] or any(paged.values())
            or routed):
        failed.append(f"launches {flat} {paged} routed {routed} != {want_b4}")
    # 8d: the named model, an unknown one, the drain.
    mine = ServeEngine(draft, slots=LM_SLOTS)
    rid = mine.submit(prompts[0], PREFIX_NEW).request.rid
    mine.run()
    named_want = mine.pop_result(rid).tokens
    (e0, n0), (e1, n1) = out["named_counts"]
    status, _, nope = out["nope"]
    r_status, r_headers, refused = out["refused"]
    drained = out["drained"]
    log(f"[named] model=draft: {out['named']['model_version']}, stream "
        f"{'equals' if out['named']['tokens'] == named_want else 'PARTS FROM'}"
        f" the depth-2 engine's in-process; tokens default {e0}->{e1}, draft "
        f"{n0}->{n1}; model=nope: {status} {nope}")
    failed += _parts(torch, draft, prompts, {0: out["named"]["tokens"]},
                     [named_want], "named")
    if e1 != e0 or n1 - n0 != PREFIX_NEW:
        failed.append(f"per-model counters {out['named_counts']}")
    if (status, nope.get("error"), nope.get("models")) != (
            400, "unknown_model", ["draft"]):
        failed.append(f"model=nope: {status} {nope}")
    log(f"[drain] SIGTERM with {out['drain_in_flight']} requests in flight: "
        f"a new POST → {r_status} {refused} Retry-After "
        f"{r_headers.get('Retry-After')}; in flight: "
        f"{sum(r['status'] == 'complete' and len(r['tokens']) == drain_new[i] for i, r in drained.items())}"
        f"/{len(drained)} complete; main printed {lines[-1]}")
    if (r_status != 503 or refused.get("error") != "draining"
            or not r_headers.get("Retry-After")
            or out["drain_in_flight"] < DRAIN_REQUESTS
            or any(r["status"] != "complete"
                   or len(r["tokens"]) != drain_new[i]
                   for i, r in drained.items())
            or json.loads(lines[-1]).get("drained") is not True):
        failed.append("the drain")
    if failed:
        raise AssertionError(f"phase 8c-8d: {failed}")
    return {"b4": flat["flash_decode_fp32"],
            "acceptance": engine.spec_acceptance_rate()}


def check_streaming_restore(torch, bf16_dir, want, model1) -> dict:
    """Phase 8e: main() with --streaming_restore --stream_layers 1 on the
    bf16 checkpoint's epoch 1, phase 8b's prefix traffic: the streams
    against the fresh epoch-1 engine's (phase 8b), and the seconds to
    admission against those of full residency and of the monolithic
    restore."""
    from ddp_tpu_torch.ops import decode as dec

    prompts = lm_prompts(model1.spec.vocab_size)
    out = {}

    def traffic(url, made, stop):
        out["replies"] = prefix_traffic(url, prompts)

    argv = ["--checkpoint_dir", bf16_dir, "--epoch", "1",
            "--streaming_restore", "--stream_layers", "1", "--page_size",
            str(SERVE_PAGE), "--slots", str(LM_SLOTS)]
    _zero_decode_counters(dec)
    _, lines = serve_main_with(torch, argv, traffic)
    _, paged, routed = _lm_launches(dec)
    started = json.loads(lines[0])
    streamed = json.loads(lines[1])
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    # The monolithic restore of the same state, as the streaming clock
    # counts it (its manifest check runs before start()): read, then copy
    # to the card; the manifest check timed apart.
    mgr = CheckpointManager(bf16_dir)
    t0 = time.perf_counter()
    mgr.verified_epoch(1)
    verify_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono = {k: v.to(model1.device) for k, v in mgr.read_params(1).items()}
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    del mono
    failed = _parts(torch, model1, prompts,
                    {i: r["tokens"] for i, r in out["replies"].items()}, want,
                    "streaming restore")
    log(f"[stream] admission group {started['streaming_restore']}, admission "
        f"open after {streamed['admission_ready_s']} s, fully resident after "
        f"{streamed['complete_s']} s (from the restore thread's start); the "
        f"monolithic restore of the same state (read + copy to the card) "
        f"{mono_s:.4f} s, its manifest check {verify_s:.4f} s; "
        f"{sum(out['replies'][i]['tokens'] == want[i] for i in out['replies'])}"
        f"/{len(prompts)} streams identical to phase 8b's fresh epoch-1 "
        f"engine; launches {paged}, routed {routed}")
    if routed or not paged["flash_decode_paged_fp32"]:
        failed.append(f"launches {paged}, routed {routed}")
    if failed:
        raise AssertionError(f"phase 8e: {failed}")
    return {"admission_ready_s": streamed["admission_ready_s"],
            "complete_s": streamed["complete_s"], "monolithic_s": mono_s,
            "verify_s": verify_s}


def check_lm_phases(torch, card) -> tuple[dict, dict]:
    """Phases 5a, 5 (with 8a), 8b-8e, then 5m and 8f on one set of
    temporary directories: phase 5's checkpoints (about 3.1 GB) live until
    phase 8 has served them (8f's reload of the dense one included); 5m's
    (about 4 GB, one epoch kept) are removed once 8f has served them →
    (phase 5's launch counts with 5m's, phase 8's readings with 8f's)."""
    import os
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        dirs = {d: os.path.join(tmp, d) for d in ("bf16", "fp32", "routed")}
        check_routed_training(torch, dirs["routed"])
        t0 = time.perf_counter()
        trained = check_training(torch, dirs)
        log(f"[phase 8] 8a (the checkpoints and the resume, inside phase 5) "
            f"and phase 5: {time.perf_counter() - t0:.1f} s")
        served = check_lm_serving(torch, card, dirs)
        t0 = time.perf_counter()
        moe_dir = os.path.join(tmp, "moe")
        trained["moe"] = check_moe_training(torch, card, moe_dir)
        served["moe_b4p"] = check_moe_served(torch, moe_dir,
                                             dirs["bf16"])["b4p"]
        shutil.rmtree(moe_dir)
        log(f"[phase 8] 5m and 8f: {time.perf_counter() - t0:.1f} s")
        return trained, served


def check_lm_serving(torch, card, dirs) -> dict:
    """Phase 8b-8e on phase 5's checkpoints → readings."""
    import os

    t0 = time.perf_counter()
    empty = os.path.join(os.path.dirname(dirs["bf16"]), "empty")
    os.makedirs(empty, exist_ok=True)
    log(f"[swap] {card}")
    swap = check_lm_swap(torch, dirs, empty)
    torch.cuda.empty_cache()
    draft = check_trained_draft(torch, card, dirs)
    torch.cuda.empty_cache()
    stream = check_streaming_restore(torch, dirs["bf16"],
                                     swap.pop("epoch1_streams"),
                                     swap.pop("model1"))
    torch.cuda.empty_cache()
    log(f"[phase 8] wall {time.perf_counter() - t0:.1f} s (8b-8e)")
    return {"b4p": swap["b4p"], "b4": draft["b4"],
            "acceptance": draft["acceptance"], "reload": swap["reload"],
            "stream": stream}


# ---- phases 5m and 8f: the MoE causal LM from training to serving --------

# run_lm_bench's width (TRAIN_ARGS) with decode_moe's routing: 8 experts in
# every 2nd block, top-2, 2 KV heads; one epoch of 6 steps, then a second
# by resuming. One epoch's checkpoint with its Adam moments is about 4 GB,
# so only the latest is kept (it is what 8f serves).
TRAIN_MOE_ARGS = TRAIN_ARGS + ["--moe_experts", "8", "--moe_every", "2",
                               "--moe_top_k", "2", "--num_kv_heads", "2",
                               "--max_checkpoints", "1"]
TRAIN_MOE_ARGS[TRAIN_MOE_ARGS.index("--epochs") + 1] = "1"
# 8f: the served prompt's last-position logits (the serving forward, fp32)
# against train_forward's (fp32, capacity routing, B1 through its fp32
# kernel) where the training forward dropped no token.
MOE_LOGITS_ATOL = 1e-3


def _aux_in_reported_loss(torch, trainer) -> tuple[float, float, float]:
    """The step's reported loss against CE + aux_loss_weight · mean aux
    of the same forward, from a copy of the trained weights on the first
    batch (lr 0) → (reported, CE, aux)."""
    from ddp_tpu_torch.models.lm import (
        CausalLM,
        make_lm_train_step,
        next_token_loss,
    )
    from ddp_tpu_torch.train.optim import make_optimizer

    toks = trainer.tokens[:trainer.config.batch_size]
    model = CausalLM.from_state(trainer.spec, {
        k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        trainer.device, trainable=True)
    with torch.no_grad():
        logits, aux = model.train_forward(
            toks, compute_dtype=trainer.compute_dtype, return_aux=True)
        ce = float(next_token_loss(logits, toks))
    m = make_lm_train_step(model, make_optimizer(model.parameters(), "sgd",
                                                 lr=0.0),
                           compute_dtype=trainer.compute_dtype)(toks)
    out = float(m.loss), ce, float(aux)
    del model, logits
    torch.cuda.empty_cache()
    return out


def check_moe_resume(torch, args):
    """Phase 5m's second epoch: the command again with ``--epochs 2``
    resumes epoch 0 (its log line; the only epoch kept), trains epoch 1
    alone, and the parameters and Adam moments it restored equal the
    file's bit for bit (compared at the restore: the save of epoch 1
    removes epoch 0) → (trainer, failures)."""
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.trainer import main as train_main

    args = list(args)
    args[args.index("--epochs") + 1] = "2"
    real, seen = CheckpointManager.restore, []

    def restore(self, state, epoch=None):
        out = real(self, state, epoch)
        blob = self.read(out)
        opt = state.optimizer.state_dict()
        seen.append((out, [k for k, v in state.model.state_dict().items()
                           if not torch.equal(v.cpu(), blob["params"][k])],
                     [(k, i) for k in ("mu", "nu") for i, (a, b) in
                      enumerate(zip(opt[k], blob["opt_state"][k]))
                      if not torch.equal(a.cpu(), b)],
                     opt["count"] == blob["opt_state"]["count"]))
        del blob
        return out

    log(f"[moe-train] python -m ddp_tpu_torch.train {' '.join(args)}")
    tee = _Tee(sys.stdout)
    CheckpointManager.restore = restore
    try:
        with contextlib.redirect_stdout(tee):
            trainer = train_main(args)
    finally:
        CheckpointManager.restore = real
    epoch, params, moments, count = seen[0]
    mgr = CheckpointManager(args[args.index("--checkpoint_dir") + 1])
    lines = tee.text().splitlines()
    log(f"[moe-train] resumed run: first line {lines[0]!r}; restored epoch "
        f"{epoch}, {len(params)} parameters and {len(moments)} moment buffers "
        f"differ from the file, count equal {count}; trained epochs "
        f"{[h['epoch'] for h in trainer.history]}; epochs on disk "
        f"{mgr.all_epochs()}")
    if (lines[0] != "Resumed from checkpoint epoch 0" or epoch != 0 or params
            or moments or not count or mgr.all_epochs() != [1]
            or [h["epoch"] for h in trainer.history] != [2]):
        return trainer, ["the MoE run did not resume epoch 0's state bit "
                         "for bit"]
    return trainer, []


def _moe_epoch_readings(spec, cfg, h) -> dict:
    flops = _lm_flops_per_token(spec)
    rate = cfg.batch_size * cfg.seq_len / h["step_p50_s"]
    out = dict(step_p50_ms=h["step_p50_s"] * 1e3, tokens_per_s=rate,
               tokens_per_s_wall=h["tokens_per_s"],
               mfu=rate * flops / H100_BF16_FLOPS)
    log(f"[moe-train] epoch {h['epoch']}: mean loss {h['train_loss']:.4f}, "
        f"test loss {h['test_loss']:.4f}, tokens/s {h['tokens_per_s']:.1f} "
        f"(epoch wall), {rate:.1f} at the p50 step, step p50 "
        f"{h['step_p50_s'] * 1e3:.2f} ms, est. MFU {out['mfu']:.3f} "
        f"(active-expert flops, {flops / 1e9:.3f} GFLOP a token; the [E, C, "
        f"d] capacity buffer computes 2x the active expert rows), steps "
        + ", ".join(f"{x * 1e3:.1f}" for x in h["step_seconds"]))
    return out


def check_moe_training(torch, card, ckdir) -> dict:
    """Phase 5m: ``python -m ddp_tpu_torch.train``'s main() on the MoE LM
    at run_lm_bench's width (TRAIN_MOE_ARGS, bf16): epoch 0 (6 steps),
    each of B1-B3 at least depth x steps, nothing routed to the plain
    block; the reported loss is CE + 0.01 · aux; the sidecar carries the
    routing; one step through the kernels against the plain attention
    (STEP_TOL, a dropped dK tile must fail it); then the same command
    with --epochs 2 resumes epoch 0 bit for bit and trains epoch 1; the
    losses finite and falling over the two; readings of epoch 1 →
    {"launches", "readings"}."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train.checkpoint import load_lm_spec_fields
    from ddp_tpu_torch.train.trainer import main as train_main

    launches = fl.flash_attention.launches
    args = TRAIN_MOE_ARGS + ["--checkpoint_dir", ckdir]
    log(f"[moe-train] {card}; python -m ddp_tpu_torch.train {' '.join(args)}")
    _zero(launches)
    fl.flash_attention.plain_routed = 0
    with _timed_saves() as save_s:
        trainer = train_main(args)
    torch.cuda.synchronize()
    got, routed = dict(launches), fl.flash_attention.plain_routed
    spec, cfg = trainer.spec, trainer.config
    steps = trainer.runner.steps_per_epoch * cfg.epochs
    want = spec.depth * steps
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"[moe-train] {n_params / 1e6:.1f} M params (routed blocks "
        f"{[i + 1 for i in range(spec.depth) if spec.routed(i)]}), {steps} "
        f"steps, launches {got} (depth x steps = {want}), routed to the "
        f"plain block {routed}; saves "
        + ", ".join(f"{x:.2f}" for x in save_s) + " s")
    failed = [f"{n} bf16 launched {got[f'{n}_bf16']} < {want}"
              for n in FLASH_NAMES if got[f"{n}_bf16"] < want]
    if routed or any(got[f"{n}_fp32"] for n in FLASH_NAMES):
        failed.append(f"routed {routed}, or fp32 kernels launched")
    history = list(trainer.history)
    _moe_epoch_readings(spec, cfg, history[0])
    sidecar = load_lm_spec_fields(ckdir)
    if sidecar != spec._asdict() or sidecar["num_experts"] != 8:
        failed.append(f"sidecar {sidecar}")
    reported, ce, aux = _aux_in_reported_loss(torch, trainer)
    log(f"[moe-train] reported loss {reported:.6f} = CE {ce:.6f} + "
        f"{spec.aux_loss_weight} x aux {aux:.6f} "
        f"({ce + spec.aux_loss_weight * aux:.6f})")
    if (abs(reported - ce - spec.aux_loss_weight * aux) > 1e-5 * abs(reported)
            or spec.aux_loss_weight * aux < 1e-3):
        failed.append("the reported loss is not CE + weight x aux")
    profile_train_steps(torch, trainer)
    try:
        compare_step(torch, trainer, "bf16")
    except AssertionError as e:
        failed.append(str(e))
    del trainer
    torch.cuda.empty_cache()
    trainer, bad = check_moe_resume(torch, args)
    failed += bad
    history += trainer.history
    readings = _moe_epoch_readings(spec, cfg, history[-1])
    del trainer
    torch.cuda.empty_cache()
    losses = [x for h in history for x in h["loss"]]
    means = [h["train_loss"] for h in history]
    if not (all(np.isfinite(losses)) and len(means) == 2
            and means[1] < means[0]):
        failed.append(f"losses not finite and falling: {means}")
    if failed:
        raise AssertionError(f"phase 5m: {failed}")
    return {"launches": {n: got[f"{n}_bf16"] for n in FLASH_NAMES},
            "readings": readings}


def check_moe_served(torch, moe_dir, dense_dir) -> dict:
    """Phase 8f: ``python -m ddp_tpu_torch.serve``'s main() with
    --checkpoint_dir <5m> --page_size 16 on lm_prompts traffic: every
    stream equals an in-process fixed-lane engine's on the restored
    weights (near ties excepted), B4p = decode steps x depth, nothing
    else launched or routed; POST /reload of the dense phase-5 directory
    answers 409 spec_skew; each served prompt's last-position logits
    against the full-sequence serving forward (``CausalLM.forward``), and
    against train_forward's (fp32, each prompt alone) where that dropped
    no token → B4p's launches."""
    import ddp_tpu_torch.models.lm as lm_mod
    from ddp_tpu_torch.ops import decode as dec
    from ddp_tpu_torch.serve.engine import ServeEngine

    model, _, epoch = _restored(torch, moe_dir)
    prompts = lm_prompts(model.spec.vocab_size)
    out = {}

    def traffic(url, made, stop):
        out["replies"] = prefix_traffic(url, prompts)
        out["skew"] = _post_status(url, "/reload",
                                   {"checkpoint_dir": dense_dir})

    made, _ = serve_main_with(torch, ["--checkpoint_dir", moe_dir,
                                      "--page_size", str(SERVE_PAGE),
                                      "--slots", str(LM_SLOTS)], traffic)
    flat, paged, routed = _lm_launches(dec)
    engine = made[0]
    want_b4p = engine.decode_steps * engine.spec.depth
    failed = []
    if (paged["flash_decode_paged_fp32"] != want_b4p or want_b4p == 0
            or any(flat.values()) or paged["flash_decode_paged_int8"]
            or routed):
        failed.append(f"launches {flat} {paged} routed {routed}, B4p want "
                      f"{want_b4p}")
    replies = out["replies"]
    if any(r["status"] != "complete" for r in replies.values()):
        failed.append("a served request did not complete")
    fixed, _ = paged_streams(torch, model, prompts, engine=ServeEngine(
        model, slots=LM_SLOTS, max_queue=len(prompts)))
    failed += _parts(torch, model, prompts,
                     {i: r["tokens"] for i, r in replies.items()},
                     [c.tokens for c in fixed], "8f")
    status, _, body = out["skew"]
    if status != 409 or body.get("error") != "spec_skew":
        failed.append(f"/reload of the dense directory: {status} {body}")
    seen = {}
    eager = ServeEngine(model, slots=LM_SLOTS, page_size=SERVE_PAGE,
                        max_queue=len(prompts), cuda_graphs=False)
    with first_logits(eager, seen):
        rids = [eager.submit(p, 1).request.rid for p in prompts]
        eager.run()
    kept, gaps, dense_gaps = [], [], []
    real = lm_mod.moe_mlp

    def spy(*a, **kw):
        res = real(*a, **kw)
        kept[-1] = kept[-1] and bool(res[2].kept.all())
        return res

    lm_mod.moe_mlp = spy
    try:
        with torch.no_grad():
            for rid, p in zip(rids, prompts):
                kept.append(True)
                toks = torch.tensor([p], device=model.device)
                served = seen[rid].reshape(-1)
                dense_gaps.append(float((served - model(toks)[0, -1])
                                        .abs().max()))
                train = model.train_forward(toks)[0, -1]
                if kept[-1]:
                    gaps.append(float((served - train).abs().max()))
    finally:
        lm_mod.moe_mlp = real
    gap = max(gaps, default=float("nan"))
    log(f"[moe-serve] epoch {epoch}: {len(replies)} requests, "
        f"{engine.decode_steps} decode steps, B4p {paged} (want {want_b4p}), "
        f"fixed {flat}, routed {routed}; /reload of the dense directory "
        f"{status} {body.get('error')}; last-position logits of the served "
        f"prompts (the paged engine's prefill) vs the full-sequence serving "
        f"forward: max |diff| {max(dense_gaps):.3e}; vs train_forward (fp32, "
        f"each prompt alone): {len(gaps)}/{len(prompts)} prompts without a "
        f"dropped token, max |diff| over them {gap:.3e} (limit "
        f"{MOE_LOGITS_ATOL} both)")
    if max(dense_gaps) > MOE_LOGITS_ATOL or (gaps and gap > MOE_LOGITS_ATOL):
        failed.append(f"served logits differ: {max(dense_gaps)}, {gap}")
    del model, eager, made
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 8f: {failed}")
    return {"b4p": paged["flash_decode_paged_fp32"]}


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


def _train(args: list[str], base=CNN_ARGS):
    """``python -m ddp_tpu_torch.train``'s own main() in-process on
    ``base`` + ``args`` → (trainer or None, the lines it printed)."""
    import contextlib

    from ddp_tpu_torch.train.trainer import main as train_main

    argv = base + CNN_DEVICE_ARGS + args
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
    _flip_byte(f"{ckdir}/epoch_3/state.pt")
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


def profile_cnn_epoch(torch, trainer, label, steps=None) -> float:
    """Busy share of one more epoch of ``trainer`` under torch.profiler
    (its first ``steps`` steps on the loader path, when given): summed
    CUDA kernel time over the wall time (the profiler's own host cost
    included)."""
    import itertools

    from torch.profiler import ProfilerActivity, profile

    from ddp_tpu_torch.runtime import dist
    from ddp_tpu_torch.train.fast import run_steps

    epoch = trainer.config.epochs + 7
    dist.setup(device=str(trainer.device))  # the step all-reduces
    try:
        if steps is not None and trainer.fast_runner is None:
            # One step first: the new group's first all-reduce sets up its
            # communicator, which a short window would count as host time.
            run_steps(trainer.train_step, itertools.islice(
                trainer.loader.epoch(epoch - 1), 1), on_gpu=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if trainer.fast_runner is not None:
                trainer.fast_runner(epoch)
            else:
                run_steps(trainer.train_step, itertools.islice(
                    trainer.loader.epoch(epoch), steps), on_gpu=True)
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
    flash = sum(e.self_device_time_total for e in rows
                if any(sym in e.key for sym in FLASH_SYMBOLS)) / 1e6
    steps = min(steps or trainer.steps_per_epoch, trainer.steps_per_epoch)
    if trainer.fast_runner is not None:
        steps = trainer.steps_per_epoch
    log(f"[profile] {label}: {steps} steps, wall {wall * 1e3:.2f} ms, device "
        f"kernel time {busy * 1e3:.2f} ms, busy share {busy / wall:.3f}, "
        f"flash kernels B1-B3 {flash / busy:.3f} of device time")
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


# ---- phase 7: the image families of BASELINE.json --------------------------

# BASELINE.json config 4, ViT-Tiny on CIFAR-100 (attention path, bf16):
# bench.py run_vit_bench's model, batch and optimizer (bench.py:380-416),
# the synthetic split cut to 12,800 images (50 steps an epoch) so that the
# phase stays short.
VIT_ARGS = ["--model", "vit_tiny", "--dataset", "cifar100", "--synthetic_data",
            "--synthetic_size", "12800", "--batch_size", "256", "--epochs",
            "2", "--optimizer", "sgd", "--lr", "0.01", "--momentum", "0.9",
            "--compute_dtype", "bfloat16", "--augment", "crop_flip",
            "--log_interval", "1000"]
# The bf16 step's loss limit (STEP_TOL's 1e-5 is below the floor here):
# ViT's residual stream is bf16, so a one-ulp change in a few attention
# outputs moves the loss, a mean over 64 images, by ~1e-4. On an NVIDIA
# H100 80GB HBM3 at 700 W, kernel vs plain read 1.33e-4, and a B1 that
# counts the tile's zero-filled keys 3.36e-2.
VIT_BF16_LOSS_TOL = 1e-3
# Train flops an image, bench.py:454-457's count for ViT-Tiny at 32×32.
VIT_TRAIN_FLOPS = 2_187_095_040
# Steps profiled for phase 7's busy share: the profiler's processing of a
# whole epoch (over 1,000 launches a ViT step) takes over a minute.
PROFILE_STEPS = 12
# BASELINE.json config 3, ResNet-18 on CIFAR-10: He et al. 2016 §4.2's
# CIFAR recipe (batch 128, lr 0.1, momentum 0.9, weight decay 1e-4), fp32,
# the synthetic split cut to 12,800 images (100 steps an epoch).
RESNET_ARGS = ["--model", "resnet18", "--dataset", "cifar10",
               "--synthetic_data", "--synthetic_size", "12800",
               "--batch_size", "128", "--epochs", "2", "--lr", "0.1",
               "--momentum", "0.9", "--weight_decay", "1e-4", "--augment",
               "crop_flip", "--log_interval", "1000"]


def _losses_fall(trainer) -> list[str]:
    losses = [l for h in trainer.history for l in h["loss"]]
    means = [h["train_loss"] for h in trainer.history]
    if not (losses and all(np.isfinite(losses)) and len(means) == 2
            and means[1] < means[0]):
        return [f"losses not finite and falling: epoch means {means}"]
    return []


def _resume_failures(torch, args, base, ckdir) -> list[str]:
    """epoch_0..1 verified; the same command again resumes from epoch 1
    with nothing to train and the state of epoch_1 bit for bit
    (parameters, BatchNorm buffers, step count, momentum)."""
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckdir)
    verified = {e: mgr.verify_epoch(e) for e in mgr.all_epochs()}
    again, out = _train(args, base)
    bad = _cnn_state_errors(torch, again, mgr.read(1))
    log(f"[image] epochs saved {sorted(verified)}, manifest problems "
        f"{verified}; re-run: epochs trained {len(again.history)}, state vs "
        f"epoch_1 differs in {bad or 'nothing'}")
    failed = []
    if sorted(verified) != [0, 1] or any(v != [] for v in verified.values()):
        failed.append("epoch_0..1 missing or unverified")
    if "Resumed from checkpoint epoch 1" not in out or again.history or bad:
        failed.append("the re-run does not resume epoch 1's state")
    return failed


def _image_readings(torch, trainer, label, card, flops=None) -> dict:
    """The last epoch's images/s and step p50, the busy share of
    PROFILE_STEPS more steps under torch.profiler, and the estimated MFU
    (bf16 peak) given the train flops an image."""
    h = trainer.history[-1]
    busy = profile_cnn_epoch(torch, trainer, label, PROFILE_STEPS)
    rate = trainer.global_batch_size / h["step_p50_s"]
    mfu = rate * flops / H100_BF16_FLOPS if flops else None
    log(f"[time] {label} ({card}): {h['images_per_s_per_card']:.1f} images/s "
        f"per card over the epoch, {rate:.1f} at the p50 step "
        f"{h['step_p50_s'] * 1e3:.3f} ms"
        + (f", est. MFU {mfu:.4f}" if mfu else "")
        + f", busy share {busy:.3f} (under the profiler)")
    return dict(images_per_s=h["images_per_s_per_card"],
                step_p50_ms=h["step_p50_s"] * 1e3, busy=busy, mfu=mfu)


def _vit_step(torch, trainer, x, y, attention_fn, dtype):
    """One SGD-momentum step in ``dtype`` of a copy of ``trainer``'s ViT
    on (x, y), every block's attention through ``attention_fn`` (None:
    the default, B1-B3) → (loss, {parameter name: gradient})."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    src = trainer.state.model
    model = get_model(trainer.config.model, num_classes=src.head.out_features,
                      side=32, in_channels=3, depth=len(src.block_names))
    model.load_state_dict(src.state_dict())
    model = model.to(trainer.device)
    for name in model.block_names:
        getattr(model, name).attn.attention_fn = attention_fn
    state = TrainState(0, model, make_optimizer(model.parameters(), "sgd",
                                                lr=0.01, momentum=0.9))
    m = make_train_step(state, reduce=lambda t: t, compute_dtype=dtype)(x, y)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return float(m.loss), grads


def _zero_keys_counted(torch, q, k, v):
    """The plain non-causal attention over the one 128-key tile with the
    63 rows past S filled with zeros and counted by the softmax: what a
    B1 that forgot the key mask of TMA's zero fill would give."""
    pad = (0, 0, 0, 0, 0, 128 - k.shape[1])
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     torch.nn.functional.pad(k.float(), pad))
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p,
                     torch.nn.functional.pad(v.float(), pad))
    return o.to(q.dtype)


def check_vit_step(torch, trainer, *, batch=64, tag="vit") -> list[str]:
    """Phase 7a's step check: one step through B1-B3 against the same step
    through the plain attention (which must launch nothing), from the
    trained weights on the first ``batch`` training images, held to
    STEP_TOL (in bf16 with VIT_BF16_LOSS_TOL for the loss). Two negative
    controls must fail the same limits: a B1 that counts the tile's
    zero-filled keys past row 64 (it moves the loss), and a B3 that drops
    the ragged tail (the dK and dV of key row 64; it leaves the loss and
    moves the gradients)."""
    from ddp_tpu_torch.ops import flash as fl

    images, labels = trainer.train_split
    x = torch.from_numpy(images[:batch]).to(trainer.device)
    y = torch.from_numpy(labels[:batch]).to(trainer.device)
    drop = _drop_key_grad(torch, slice(-1, None))

    def plain(q, k, v):
        return fl.attention_with_lse_reference(q, k, v, False)[0]

    controls = {
        "zero-filled keys 65-127 counted by the softmax":
            lambda q, k, v: _zero_keys_counted(torch, q, k, v),
        "dK/dV of key row 64 dropped": lambda q, k, v: plain(q, drop(k),
                                                             drop(v)),
    }
    failed = []
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        limits = STEP_TOL[dname]
        if dname == "bf16":
            limits = dict(limits, loss=VIT_BF16_LOSS_TOL)
        routes, flips = [], []
        with fixed_routing(torch, routes, flips):
            kernel = _vit_step(torch, trainer, x, y, None, dtype)
        _zero(fl.flash_attention.launches)
        with fixed_routing(torch, routes, flips):
            want = _vit_step(torch, trainer, x, y, plain, dtype)
        e = _grad_errors(kernel, want)
        log(f"[{tag}] one {dname} step, kernel vs plain attention (batch "
            f"{batch}): loss {kernel[0]:.6f} vs {want[0]:.6f}; "
            f"{_errors_text(e)} (limits {limits})"
            + (f"; routing held to the kernel step's, own choices would "
               f"differ at {flips} (token, k) per routed block"
               if routes else ""))
        if not _within(e, limits):
            failed.append(f"the {dname} kernel step disagrees with the "
                          "plain one")
        del kernel
        for label, attention_fn in controls.items():
            with fixed_routing(torch, routes, []):
                got = _vit_step(torch, trainer, x, y, attention_fn, dtype)
            e = _grad_errors(got, want)
            del got
            log(f"[{tag}] {dname} control, {label}, vs plain: "
                f"{_errors_text(e)}")
            if _within(e, limits):
                failed.append(f"the {dname} check passes a control: {label}")
        if any(fl.flash_attention.launches.values()):
            failed.append(f"the plain path launched "
                          f"{fl.flash_attention.launches}")
    return failed


def check_vit(torch, card, tmp) -> dict:
    """Phase 7a: ViT-Tiny on CIFAR-100 through ``python -m
    ddp_tpu_torch.train``'s main(), the launch counts of its run (each of
    B1-B3 at least depth x steps, nothing routed), losses, checkpoints and
    resume, the kernel-vs-plain step, and the readings."""
    from ddp_tpu_torch.ops import flash as fl

    launches = fl.flash_attention.launches
    ckdir = f"{tmp}/vit"
    _zero(launches)
    fl.flash_attention.plain_routed = 0
    trainer, _ = _train(["--checkpoint_dir", ckdir], VIT_ARGS)
    torch.cuda.synchronize()
    got, routed = dict(launches), fl.flash_attention.plain_routed
    depth = len(trainer.state.model.block_names)
    steps = trainer.steps_per_epoch * trainer.config.epochs
    log(f"[vit] {sum(p.numel() for p in trainer.state.model.parameters()) / 1e6:.2f}"
        f" M params, depth {depth}, {steps} steps: launches {got} (depth x "
        f"steps = {depth * steps}), blocks routed to the plain block {routed}")
    for h in trainer.history:
        log(_epoch_line(h, "vit_tiny cifar100 bf16,").replace("[cnn]", "[vit]"))
    failed = [f"{n} bf16 launched {got[f'{n}_bf16']} < {depth * steps}"
              for n in FLASH_NAMES if got[f"{n}_bf16"] < depth * steps]
    if routed:
        failed.append(f"{routed} blocks routed to the plain block")
    if any(got[f"{n}_fp32"] for n in FLASH_NAMES):
        failed.append("fp32 kernels launched in a bf16 run")
    failed += _losses_fall(trainer)
    failed += _resume_failures(torch, ["--checkpoint_dir", ckdir], VIT_ARGS,
                               ckdir)
    failed += check_vit_step(torch, trainer)
    readings = _image_readings(torch, trainer, "vit_tiny cifar100 bf16, "
                               "batch 256", card, VIT_TRAIN_FLOPS)
    readings["launches"] = {n: got[f"{n}_bf16"] for n in FLASH_NAMES}
    if failed:
        raise AssertionError(f"phase 7a: {failed}")
    return readings


# Phase 7c: vit_moe_tiny (8 experts, top-2, every 2nd of 12 blocks
# routed; 64 tokens, no cls) on the same split and recipe as 7a.
VIT_MOE_ARGS = VIT_ARGS[:1] + ["vit_moe_tiny"] + VIT_ARGS[2:]


def check_vit_moe(torch, card, tmp) -> dict:
    """Phase 7c: vit_moe_tiny on CIFAR-100 through main(), as 7a: each of
    B1-B3 at least depth x steps, nothing routed; losses finite and
    falling; epoch_0..1 verified and a bit-exact resume; one step through
    the kernels against the plain attention (7a's limits and controls;
    the loss includes 0.01 x the routed blocks' aux sum) → readings."""
    from ddp_tpu_torch.ops import flash as fl

    launches = fl.flash_attention.launches
    ckdir = f"{tmp}/vit_moe"
    _zero(launches)
    fl.flash_attention.plain_routed = 0
    trainer, _ = _train(["--checkpoint_dir", ckdir], VIT_MOE_ARGS)
    torch.cuda.synchronize()
    got, routed = dict(launches), fl.flash_attention.plain_routed
    model = trainer.state.model
    depth = len(model.block_names)
    steps = trainer.steps_per_epoch * trainer.config.epochs
    log(f"[vit-moe] {card}; {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
        f" M params, depth {depth} (routed "
        f"{sum(hasattr(getattr(model, b), 'moe') for b in model.block_names)}"
        f"), {steps} steps: launches {got} (depth x steps = {depth * steps}), "
        f"blocks routed to the plain block {routed}")
    for h in trainer.history:
        log(_epoch_line(h, "vit_moe_tiny cifar100 bf16,").replace("[cnn]",
                                                                  "[vit-moe]"))
    failed = [f"{n} bf16 launched {got[f'{n}_bf16']} < {depth * steps}"
              for n in FLASH_NAMES if got[f"{n}_bf16"] < depth * steps]
    if routed or any(got[f"{n}_fp32"] for n in FLASH_NAMES):
        failed.append(f"routed {routed}, or fp32 kernels launched")
    failed += _losses_fall(trainer)
    failed += _resume_failures(torch, ["--checkpoint_dir", ckdir],
                               VIT_MOE_ARGS, ckdir)
    failed += check_vit_step(torch, trainer, tag="vit-moe")
    readings = _image_readings(torch, trainer, "vit_moe_tiny cifar100 bf16, "
                               "batch 256", card)
    readings["launches"] = {n: got[f"{n}_bf16"] for n in FLASH_NAMES}
    if failed:
        raise AssertionError(f"phase 7c: {failed}")
    return readings


class _TiedRelu:
    """Stands in for ``torch.nn.functional`` in ``models/resnet`` during one
    step: ``relu`` records each call's sign pattern (no ``masks`` given)
    or applies the recorded one and counts where its own input's sign
    differs (``flips``). A ReLU's kink is the one place where a rounding
    of ~1e-7 can change the step by more than that: a pre-activation of
    ~1e-6 that two fp32 sums put on opposite sides of 0 moves the
    gradient of every layer below it. Tied masks compare two steps on
    the same piece of the piecewise-linear function."""

    def __init__(self, F, masks=None):
        self._F, self.record = F, masks is None
        self.masks, self.flips, self._i = masks or [], 0, 0

    def __getattr__(self, name):
        return getattr(self._F, name)

    def relu(self, x):
        if self.record:
            self.masks.append((x > 0).cpu())
            return self._F.relu(x)
        m = self.masks[self._i].to(x.device)
        self._i += 1
        self.flips += int(((x > 0) != m).sum())
        return x.where(m, x.new_zeros(()))


def _resnet_step(torch, state_np, x, y, device, dtype=None, relu=None):
    """One step of the recipe (SGD 0.1, momentum 0.9, wd 1e-4, fp32, or
    fp64 with ``dtype=torch.float64``) of ResNet-18 from ``state_np`` on
    (x, y) on ``device``, its ReLUs through ``relu`` (a _TiedRelu) if
    given → (loss, and as CPU tensors the gradients, the updated
    parameters and the BatchNorm buffers after the step)."""
    from ddp_tpu_torch.models import get_model, resnet
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    dtype = dtype or torch.float32
    model = get_model("resnet18", num_classes=10, side=32, in_channels=3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_np.items()})
    model = model.to(device, dtype)
    state = TrainState(0, model, make_optimizer(
        model.parameters(), "sgd", lr=0.1, momentum=0.9, weight_decay=1e-4))
    F = resnet.F
    resnet.F = relu or F
    try:
        m = make_train_step(state, reduce=lambda t: t, compute_dtype=dtype)(
            torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    finally:
        resnet.F = F
    cpu = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return (float(m.loss),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: cpu[n] for n, _ in model.named_parameters()},
            {n: t for n, t in cpu.items() if "running" in n})


def _live_bn_scales(state_np, seed=1) -> dict:
    """``state_np`` with every BatchNorm scale drawn from U[0.5, 1.5], as
    the CPU tests draw them. At the zero-gamma init the gradients of both
    convs and the first BatchNorm of every block are exactly 0 on both
    sides, so a step compared there would not test them."""
    rng = np.random.default_rng(seed)
    return {n: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                if n.endswith(".weight") and v.ndim == 1 else v)
            for n, v in state_np.items()}


def _resnet_errors(got, want) -> tuple[dict, tuple[str, float]]:
    """_cnn_step_errors, and the worst running buffer (name, error)."""
    bufs = max(((n, float((got[3][n] - w).norm() / w.norm().clamp_min(1e-30)))
                for n, w in want[3].items()), key=lambda t: t[1])
    return _cnn_step_errors(got, want), bufs


def _resnet_text(e, bufs) -> str:
    return (f"{_cnn_errors_text(e)}; worst running buffer {bufs[1]:.2e} "
            f"({bufs[0]})")


def check_resnet_step(torch, trainer, *, batch=32) -> list[str]:
    """Phase 7b's step check, as phase 6c's: one step on the card (fp32,
    TF32 off) against the same step on the CPU on the first ``batch``
    training images, from the seeded weights with live BatchNorm scales
    (_live_bn_scales) and from the trained weights, with the CPU's ReLU
    masks tied to the card's (_TiedRelu), held to CNN_STEP_TOL: loss,
    gradient, every gradient, every updated parameter and every running
    buffer after the step. A control must fail it: the card's step with
    the gradients of the blocks' convs zeroed (what the zero-gamma init
    would let pass). Readings: the masks' flips, the CPU's step with its
    own masks, and a witness, the CPU's fp64 step on the card's masks,
    from which each fp32 step's distance is printed."""
    import torch.nn.functional as F

    images, labels = trainer.train_split
    x, y = images[:batch], labels[:batch]
    seeded = _live_bn_scales(trainer.state.model.init_state(
        trainer.config.seed))
    trained = {k: v.detach().cpu().numpy()
               for k, v in trainer.state.model.state_dict().items()}
    failed = []
    for label, state_np in (("seeded", seeded), ("trained", trained)):
        card = _TiedRelu(F)
        got = _resnet_step(torch, state_np, x, y, trainer.device, relu=card)
        tied = _TiedRelu(F, card.masks)
        want = _resnet_step(torch, state_np, x, y, "cpu", relu=tied)
        own = _resnet_step(torch, state_np, x, y, "cpu")
        exact = _resnet_step(torch, state_np, x, y, "cpu", torch.float64,
                             relu=_TiedRelu(F, card.masks))
        e, bufs = _resnet_errors(got, want)
        log(f"[resnet] one step from the {label} weights, card vs CPU (fp32, "
            f"TF32 off, batch {batch}, ReLU masks tied): loss {got[0]:.6f} "
            f"vs {want[0]:.6f}; {_resnet_text(e, bufs)} (limits "
            f"{CNN_STEP_TOL})")
        log(f"[resnet] reading, {label}: {tied.flips} of "
            f"{sum(m.numel() for m in card.masks)} ReLU inputs on the other "
            f"side of 0 on the CPU; the CPU's step with its own masks vs the "
            f"card's: {_resnet_text(*_resnet_errors(got, own))}")
        for side, step in (("card", got), ("CPU", want)):
            log(f"[resnet] witness, {label}: the {side}'s fp32 step vs the "
                f"CPU's fp64 (masks tied): "
                f"{_resnet_text(*_resnet_errors(step, exact))}")
        if not (_cnn_within(e) and bufs[1] <= CNN_STEP_TOL["leaf"]):
            failed.append(f"the card's step from the {label} weights "
                          "disagrees with the CPU's")
        if label == "seeded":
            blind = (got[0], {n: g * 0 if ".Conv_" in n else g
                              for n, g in got[1].items()}, got[2], got[3])
            e, bufs = _resnet_errors(blind, want)
            log(f"[resnet] control, the card's step with the blocks' conv "
                f"gradients zeroed: {_resnet_text(e, bufs)}")
            if _cnn_within(e):
                failed.append("the check passes a step without the blocks' "
                              "conv gradients")
    return failed


def check_resnet_eval(torch, trainer, *, batch=128) -> list[str]:
    """Evaluation normalises by the running averages: the eval step's
    loss on a batch differs from a train-mode forward's on the same
    batch."""
    import torch.nn.functional as F

    from ddp_tpu_torch.parallel.common import _preprocess
    from ddp_tpu_torch.parallel.ddp import make_eval_step

    images, labels = trainer.test_split
    batch = min(batch, len(labels))
    x = torch.from_numpy(images[:batch]).to(trainer.device)
    y = torch.from_numpy(labels[:batch]).to(trainer.device)
    model = trainer.state.model
    _, total = make_eval_step(model, reduce=lambda t: t)(
        x, y, torch.ones(batch, device=trainer.device))
    model.train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        train_loss = F.cross_entropy(model(_preprocess(x, torch.float32)),
                                     y.long(), reduction="sum")
    model.load_state_dict(state)  # the forward advanced the running stats
    eval_loss, train_loss = float(total) / batch, float(train_loss) / batch
    log(f"[resnet] loss on a test batch of {batch}: eval mode (running "
        f"averages) {eval_loss:.6f}, train mode (batch statistics) "
        f"{train_loss:.6f}")
    if abs(eval_loss - train_loss) <= 1e-3 * abs(eval_loss):
        return ["evaluation does not use the running averages"]
    return []


def check_resnet(torch, card, tmp) -> dict:
    """Phase 7b: ResNet-18 on CIFAR-10 through ``python -m
    ddp_tpu_torch.train``'s main(), fp32 and then bf16: losses,
    checkpoints and resume, the card-vs-CPU step with the running
    buffers, evaluation by the running averages, and the readings."""
    ckdir = f"{tmp}/resnet"
    trainer, _ = _train(["--checkpoint_dir", ckdir], RESNET_ARGS)
    for h in trainer.history:
        log(_epoch_line(h, "resnet18 cifar10 fp32,").replace("[cnn]",
                                                             "[resnet]"))
    failed = _losses_fall(trainer)
    failed += _resume_failures(torch, ["--checkpoint_dir", ckdir],
                               RESNET_ARGS, ckdir)
    failed += check_resnet_step(torch, trainer)
    failed += check_resnet_eval(torch, trainer)
    readings = {"fp32": _image_readings(
        torch, trainer, "resnet18 cifar10 fp32, batch 128", card)}
    del trainer
    bf16, _ = _train(["--checkpoint_dir", f"{tmp}/resnet_bf16",
                      "--compute_dtype", "bfloat16", "--eval_every", "0"],
                     RESNET_ARGS)
    failed += _losses_fall(bf16)
    readings["bf16"] = _image_readings(
        torch, bf16, "resnet18 cifar10 bf16, batch 128", card)
    if failed:
        raise AssertionError(f"phase 7b: {failed}")
    return readings


def check_image_families(torch, card) -> dict:
    """Phase 7: ViT-Tiny / CIFAR-100 (7a), ResNet-18 / CIFAR-10 (7b),
    then vit_moe_tiny / CIFAR-100 (7c)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        vit = check_vit(torch, card, tmp)
        torch.cuda.empty_cache()
        resnet = check_resnet(torch, card, tmp)
        torch.cuda.empty_cache()
        vit_moe = check_vit_moe(torch, card, tmp)
    return {"vit": vit, "resnet": resnet, "vit_moe": vit_moe}


# ---- phase 9: the trainer's fault tolerance --------------------------------

# Appended to every phase-9 command (["--device", "cpu"] when rehearsing).
FT_DEVICE_ARGS: list[str] = []
# 9a: run_lm_bench's width (phase 5's TRAIN_ARGS: 2 epochs of 6 steps,
# bf16); the SIGTERM lands before global step 8, epoch 1's batch 2.
FT_SIGTERM_STEP = 8
# 9b: the reference's path (train.py --epochs 3 --batch_size 64, SGD
# 0.01) on synthetic MNIST cut from 60,000 to 12,800 images (200 steps an
# epoch), every run under the supervisor (one worker process, as the
# drills run), cuDNN deterministic (without it two uninterrupted runs
# part by ~6e-8: a conv backward's order); the kill lands in epoch 1, the
# stall in epoch 1.
FT_CNN_ARGS = ["--model", "simple_cnn", "--synthetic_data",
               "--synthetic_size", "12800", "--epochs", "3", "--batch_size",
               "64", "--log_interval", "300", "--deterministic"]
FT_KILL_STEP = 300
FT_STALL = "stall:input@step250:30s"
# 9c: two gloo ranks on the one card at 32 each (global 64), 3 epochs of
# 200 steps; rank 1 is lost in epoch 1, a host comes back at epoch 2.
FT_ELASTIC_CHAOS = "shrink:rank1@step300,grow:+1@epoch2"
# 9d: phase 7a's ViT-Tiny recipe with the EMA and keep_best.
FT_EMA_DECAY = 0.999
FT_EMA_TOL = 1e-6  # relative norm error, card fp32 EMA vs fp64 recurrence
# 9e: the imported network's logits, card (fp32, TF32 off) vs the CPU.
FT_IMPORT_ATOL = 1e-5
FT_SYNC_STEPS = 8  # steady LM steps counted with and without the arming


@contextlib.contextmanager
def _patched(*triples):
    """``setattr(owner, name, value)`` for each (owner, name, value) inside
    the block; afterwards each attribute is as it was (an inherited one
    shows through again)."""
    saved = [(owner, name, vars(owner).get(name, _patched))
             for owner, name, _ in triples]
    for owner, name, value in triples:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, old in saved:
            if old is _patched:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


def _records(path) -> list[dict]:
    import os

    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path) if line.strip()]


def _finished(records) -> bool:
    """The stream ends with the run's ``final`` record, a finite loss."""
    return bool(records) and records[-1]["kind"] == "final" and \
        records[-1]["loss"] is not None


def _platform_failures(records, label) -> list[str]:
    """Every generation's run_start names the card (build_info)."""
    starts = [r for r in records if r["kind"] == "run_start"]
    bad = [s["build_info"] for s in starts
           if s["build_info"].get("platform") != "gpu"]
    if not starts or bad:
        return [f"{label}: a generation ran off the card ({len(starts)} "
                f"run_start records, off-card {bad})"]
    return []


def _state_of(trainer):
    """(parameters, optimizer buffers by name and index), on the card."""
    opt = trainer.optimizer
    bufs = {f"{k}{i}": b for k in ("trace", "mu", "nu", "ema")
            for i, b in enumerate(getattr(opt, k, None) or [])}
    return dict(trainer.model.state_dict()), bufs, opt.count


def _state_diff(torch, a, b) -> tuple[bool, float]:
    """(bit for bit, the largest element-wise difference) of two
    _state_of results."""
    (pa, oa, ca), (pb, ob, cb) = a, b
    same = ca == cb and set(pa) == set(pb) and set(oa) == set(ob)
    worst = 0.0
    for x, y in [(pa[k], pb[k]) for k in pa] + [(oa[k], ob[k]) for k in oa]:
        if not torch.equal(x, y):
            same = False
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return same, worst


def _lm_ft_run(torch, args, *, late=0, timing=None):
    """``python -m ddp_tpu_torch.train``'s main() on ``args`` in-process
    → (trainer, B1-B3 launches of training alone, of evaluation alone).
    ``late`` re-enters a preempted epoch that many batches late (the
    control); ``timing`` receives the seconds from the call to the first
    resumed step's end and each save's seconds."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train import trainer as tr
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    launches = fl.flash_attention.launches
    evals = dict.fromkeys(launches, 0)
    real_eval, real_between = tr.LMTrainer.evaluate_raw, \
        tr.LMTrainer._between_steps
    real_entry, real_save = tr.LMTrainer._mid_epoch_entry, \
        CheckpointManager.save
    t0 = time.perf_counter()

    def evaluate_raw(self):
        before = dict(launches)
        out = real_eval(self)
        for k in launches:
            evals[k] += launches[k] - before[k]
        return out

    def between_steps(self, step0, skip):
        between = real_between(self, step0, skip)

        def timed(k):
            if k == 1 and timing is not None and "first_step_s" not in timing:
                torch.cuda.synchronize()
                timing["first_step_s"] = time.perf_counter() - t0
            return between(k)

        return timed

    def entry(self, start):
        epoch, batch = real_entry(self, start)
        return epoch, batch + late if batch else batch

    def save(self, *a, **kw):
        s0 = time.perf_counter()
        out = real_save(self, *a, **kw)
        if timing is not None:
            timing.setdefault("saves", []).append(
                (kw.get("mid_batch", 0), time.perf_counter() - s0))
        return out

    _zero(launches)
    fl.flash_attention.plain_routed = 0
    with _patched((tr.LMTrainer, "evaluate_raw", evaluate_raw),
                  (tr.LMTrainer, "_between_steps", between_steps),
                  (tr.LMTrainer, "_mid_epoch_entry", entry),
                  (CheckpointManager, "save", save)):
        trainer = tr.main(args)
    torch.cuda.synchronize()
    train = {k: launches[k] - evals[k] for k in launches}
    return trainer, train, evals


def _lm_sync_failures(torch, trainer, seen) -> list:
    """FT_SYNC_STEPS steady LM steps of ``trainer`` with the watchdog,
    a chaos engine (an event past the run) and the SIGTERM handler armed,
    against the same steps with none: the synchronizing calls (sync
    debug mode "warn" plus wrappers) must be equal."""
    from ddp_tpu_torch.runtime.chaos import ChaosEngine
    from ddp_tpu_torch.train.fast import run_steps
    from ddp_tpu_torch.utils.watchdog import StepWatchdog

    G = trainer.global_batch_size
    batches = [(trainer.tokens[(i * G) % len(trainer.tokens):][:G],)
               for i in range(FT_SYNC_STEPS)]
    for args in batches[:2]:  # warm
        trainer.runner.step(*args)
    torch.cuda.synchronize()
    counts = {}
    trainer.chaos = ChaosEngine("stall:input@step1000000:1s")
    trainer.watchdog = StepWatchdog(600.0)
    for label in ("off", "armed"):
        between = None
        installed = False
        if label == "armed":
            trainer.watchdog.start()
            installed, prev = trainer._install_preemption_handler()
            between = trainer._between_steps(trainer.optimizer.count, 0)
        try:
            counts[label] = count_syncs(
                torch, None, 0, seen,
                run=lambda: run_steps(trainer.runner.step, batches,
                                      on_gpu=trainer.device.type == "cuda",
                                      between=between))
        finally:
            trainer.watchdog.stop()
            if installed:
                import signal

                signal.signal(signal.SIGTERM, prev)
    log(f"[ft] 9a {FT_SYNC_STEPS} steady LM steps, synchronizing calls: "
        f"off {counts['off']}, watchdog + chaos + preempt check armed "
        f"{counts['armed']}")
    if counts["armed"] != counts["off"]:
        return [f"arming added synchronizing calls: {counts}"]
    return []


def time_lm_ema(torch, trainer) -> None:
    """Not gated: the steady LM step without and with the parameter EMA
    (``--ema_decay``'s update after every step), in turns off, on, on,
    off, FT_SYNC_STEPS steps each between CUDA events."""
    from ddp_tpu_torch.train.optim import param_ema

    opt, G = trainer.optimizer, trainer.global_batch_size
    batches = [(trainer.tokens[(i * G) % len(trainer.tokens):][:G],)
               for i in range(FT_SYNC_STEPS)]
    ms = {"off": [], "on": []}
    for arm in ("off", "on", "on", "off"):
        opt.ema_state = param_ema(opt.params, 0.999) if arm == "on" else None
        trainer.runner.step(*batches[0])  # warm
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        for args in batches:
            trainer.runner.step(*args)
        end.record()
        torch.cuda.synchronize()
        ms[arm].append(start.elapsed_time(end) / len(batches))
    opt.ema_state = None
    log(f"[ft] 9a steady bf16 LM step (CUDA events, {FT_SYNC_STEPS} steps a "
        f"turn, off/on/on/off): without the EMA "
        + ", ".join(f"{m:.3f}" for m in ms["off"]) + " ms, with it "
        + ", ".join(f"{m:.3f}" for m in ms["on"]) + " ms")


def check_lm_preemption(torch, tmp, seen) -> tuple[dict, list]:
    """Phase 9a → (B1-B3 training launches of the preempted and resumed
    invocations, failures)."""
    import os
    import shutil

    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    failed, readings = [], {}

    def args(name, *extra):
        return TRAIN_ARGS + FT_DEVICE_ARGS + [
            "--checkpoint_dir", os.path.join(tmp, name),
            "--metrics_file", os.path.join(tmp, f"{name}.jsonl"), *extra]

    runs = []
    for name in ("whole1", "whole2"):
        t, _, _ = _lm_ft_run(torch, args(name, "--max_checkpoints", "1"))
        runs.append(_state_of(t))
        failed += _platform_failures(_records(f"{tmp}/{name}.jsonl"), name)
        shutil.rmtree(os.path.join(tmp, name))  # 1.34 GB an epoch
        del t
    bitwise, spread = _state_diff(torch, runs[0], runs[1])
    log(f"[ft] 9a two uninterrupted runs ({' '.join(TRAIN_ARGS)}): "
        + ("bitwise equal" if bitwise else f"spread {spread:.3e}"))
    chaos = ["--chaos", f"sigterm:rank0@step{FT_SIGTERM_STEP}"]
    timing = {}
    cut, train1, eval1 = _lm_ft_run(torch, args("cut", *chaos), timing=timing)
    spe = cut.steps_per_epoch
    mid_epoch, mid = divmod(FT_SIGTERM_STEP, spe)
    mgr = CheckpointManager(os.path.join(tmp, "cut"))
    blob = mgr.read_partial(mid_epoch, ("mid_batch", "step"))
    pre_s = [s for m, s in timing.get("saves", []) if m]
    log(f"[ft] 9a --chaos sigterm:rank0@step{FT_SIGTERM_STEP}: preempted "
        f"{cut.summary.get('preempted')}, epochs {mgr.all_epochs()}, epoch "
        f"{mid_epoch} saved at mid_batch {blob.get('mid_batch')} (step "
        f"{blob.get('step')}), the preemption save "
        + ", ".join(f"{s:.2f}" for s in pre_s) + " s")
    if not (cut.summary.get("preempted") and blob.get("mid_batch") == mid
            and mgr.all_epochs() == [0, mid_epoch] and pre_s
            and mgr.verify_epoch(mid_epoch) == []):
        failed.append(f"the SIGTERM run did not save epoch {mid_epoch} at "
                      f"mid_batch {mid}")
    del cut
    # The control resumes a hard-linked copy of the preempted directory.
    shutil.copytree(os.path.join(tmp, "cut"), os.path.join(tmp, "late"),
                    copy_function=os.link)
    timing = {}
    resumed, train2, eval2 = _lm_ft_run(torch, args("cut", *chaos),
                                        timing=timing)
    got = _state_of(resumed)
    same, err = _state_diff(torch, got, runs[0])
    ok = same if bitwise else err <= spread
    log(f"[ft] 9a the re-run resumed epoch {mid_epoch} at batch {mid}: "
        f"{timing.get('first_step_s', float('nan')):.2f} s from the call to "
        f"the first resumed step's end; trained "
        f"{[len(h['loss']) for h in resumed.history]} steps; final "
        f"parameters and Adam state vs the uninterrupted run: "
        + ("bitwise equal" if same else f"max |diff| {err:.3e}")
        + f" (held to {'bitwise' if bitwise else f'the spread {spread:.3e}'})")
    if not ok or resumed.summary.get("preempted"):
        failed.append(f"the resumed run differs from the uninterrupted one "
                      f"({err:.3e})")
    steps = spe * resumed.config.epochs
    depth = resumed.spec.depth
    for name in FLASH_NAMES:
        k = f"{name}_bf16"
        n = train1[k] + train2[k]
        readings[name] = n
        log(f"[ft] 9a {name}: {train1[k]} + {train2[k]} = {n} launches in "
            f"training over both invocations (steps x depth = "
            f"{steps * depth}); evaluation {eval1[k] + eval2[k]}")
        if n != steps * depth:
            failed.append(f"{name}: {n} training launches, not steps x depth "
                          f"{steps * depth}")
    failed += _platform_failures(_records(f"{tmp}/cut.jsonl"), "sigterm")
    failed += _lm_sync_failures(torch, resumed, seen)
    time_lm_ema(torch, resumed)
    del resumed
    late, _, _ = _lm_ft_run(torch, args("late", *chaos), late=1)
    same, err = _state_diff(torch, _state_of(late), runs[0])
    log(f"[ft] 9a control, re-entering one batch late: "
        + ("bitwise equal" if same else f"max |diff| {err:.3e}"))
    if same or (not bitwise and err <= spread):
        failed.append("a resume one batch late passed the comparison")
    del late, runs, got
    torch.cuda.empty_cache()
    return readings, failed


def _launch(argv, log_path):
    """``python -m ddp_tpu_torch.train`` on ``argv`` in a process of its
    own (its supervisor and ranks below it), output to ``log_path``."""
    import os

    log(f"[ft] python -m ddp_tpu_torch.train {' '.join(argv)}")
    out = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-m", "ddp_tpu_torch.train",
                             *argv], stdout=out, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _run_all(commands: dict, tmp) -> dict:
    """The commands (name → argv) at once, each in its own process, all
    awaited (and killed on the way out) → name → (exit code, the lines
    of its output)."""
    procs = {name: _launch(argv, f"{tmp}/{name}.log")
             for name, argv in commands.items()}
    try:
        codes = {name: p.wait(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (codes[name], open(f"{tmp}/{name}.log").read().splitlines())
            for name in commands}


def _final_state(torch, ckdir):
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckdir)
    return mgr.read(mgr.latest_epoch())


def _blob_diff(torch, a, b) -> tuple[bool, float]:
    pa = dict(a["params"], **{f"t{i}": t for i, t in
                              enumerate(a["opt_state"]["trace"] or [])})
    pb = dict(b["params"], **{f"t{i}": t for i, t in
                              enumerate(b["opt_state"]["trace"] or [])})
    same, worst = a["step"] == b["step"], 0.0
    for k in pa:
        if not torch.equal(pa[k], pb[k]):
            same = False
            worst = max(worst, float((pa[k] - pb[k]).abs().max()))
    return same, worst


def _drill_failed(label, code, lines) -> list[str]:
    if code == 0:
        return []
    log(f"[ft] {label} exited {code}; its last lines:\n"
        + "\n".join(lines[-30:]))
    return [f"{label}: exit {code}"]


def check_drills(torch, tmp) -> list:
    """Phases 9b and 9c, their supervised commands run at once (each
    supervisor and its ranks in processes of their own, sharing the card)
    → failures, each named by its phase."""
    import os

    from ddp_tpu_torch.train.checkpoint import load_elastic_contract

    base = FT_CNN_ARGS + FT_DEVICE_ARGS
    kill, wd, el = f"{tmp}/kill", f"{tmp}/wd", f"{tmp}/elastic"
    runs = _run_all({
        # Two uninterrupted runs, under the drills' conditions (a worker
        # process).
        "w1": base + ["--checkpoint_dir", f"{tmp}/w1", "--max_restarts", "1"],
        "w2": base + ["--checkpoint_dir", f"{tmp}/w2", "--max_restarts", "1"],
        "kill": base + ["--checkpoint_dir", kill, "--metrics_file",
                        f"{kill}.jsonl", "--max_restarts", "1", "--chaos",
                        f"kill:rank0@step{FT_KILL_STEP}"],
        # The stall outlasts the timeout → exit 124, classified; the
        # restart completes, and a second stall would time it out too.
        "wd": base + ["--checkpoint_dir", wd, "--metrics_file", f"{wd}.jsonl",
                      "--watchdog_timeout", "5", "--max_restarts", "1",
                      "--chaos", FT_STALL],
        "elastic": base + ["--batch_size", "32", "--spawn", "2", "--backend",
                           "gloo", "--elastic", "--min_world", "1",
                           "--max_restarts", "2", "--chaos", FT_ELASTIC_CHAOS,
                           "--checkpoint_dir", el, "--metrics_file",
                           f"{el}.jsonl"],
    }, tmp)
    failed = []
    for name in ("w1", "w2"):
        failed += _drill_failed(f"uninterrupted run {name}", *runs[name])
    if failed:
        return [f"9b: {f}" for f in failed]
    whole = [_final_state(torch, f"{tmp}/{name}") for name in ("w1", "w2")]
    bitwise, spread = _blob_diff(torch, whole[0], whole[1])
    log(f"[ft] 9b two uninterrupted runs: "
        + ("bitwise equal" if bitwise else f"spread {spread:.3e}"))

    code, lines = runs["kill"]
    failed += _drill_failed("kill drill", code, lines)
    records = _records(f"{kill}.jsonl")
    starts = [r for r in records if r["kind"] == "run_start"]
    killed_at = os.path.getmtime(f"{kill}/chaos_ledger.rank0.json")
    back_s = starts[-1]["time"] - killed_at if len(starts) == 2 else None
    same, err = _blob_diff(torch, _final_state(torch, kill), whole[0])
    restart = [l for l in lines if "killed by SIGKILL" in l]
    log(f"[ft] 9b kill drill: supervisor {restart}; generations "
        f"{len(starts)}, restarts {[s['restarts'] for s in starts]}; kill to "
        f"the relaunched generation's run_start (restore done) "
        f"{back_s if back_s is None else f'{back_s:.2f}'} s; final state vs "
        f"the uninterrupted run: "
        + ("bitwise equal" if same else f"max |diff| {err:.3e}"))
    if (not restart or len(starts) != 2 or not _finished(records)
            or not (same if bitwise else err <= spread)):
        failed.append(f"kill drill: {restart}, {len(starts)} generations, "
                      f"diff {err:.3e}")
    failed += _platform_failures(records, "kill drill")

    # Corrupt: the kill drill's latest epoch; the same command again, here.
    corrupt = f"{tmp}/corrupt.jsonl"
    trainer, _ = _train(["--checkpoint_dir", kill, "--metrics_file", corrupt,
                         "--chaos", "ckpt_corrupt:latest"], base)
    records = _records(corrupt)
    fallback = [r for r in records if r["kind"] == "fallback"]
    trained = [h["epoch"] for h in trainer.history]
    log(f"[ft] 9b ckpt_corrupt:latest: fallback records {fallback}; "
        f"quarantine.epoch-2 {os.path.isdir(f'{kill}/quarantine.epoch-2')}; "
        f"epochs trained {trained}")
    if not (len(fallback) == 1 and fallback[0]["epoch"] == 2
            and fallback[0]["resumed_epoch"] == 1 and trained == [2]
            and os.path.isdir(f"{kill}/quarantine.epoch-2")):
        failed.append(f"corrupt drill: {fallback}, trained {trained}")
    failed += _platform_failures(records, "corrupt drill")

    code, lines = runs["wd"]
    failed += _drill_failed("watchdog drill", code, lines)
    records = _records(f"{wd}.jsonl")
    timeouts = [l for l in lines if "watchdog timeout (hang converted to "
                "exit 124)" in l]
    ledger = json.load(open(f"{wd}/chaos_ledger.rank0.json"))
    log(f"[ft] 9b watchdog drill: supervisor {timeouts}; ledger {ledger}; "
        f"generations {sum(r['kind'] == 'run_start' for r in records)}; "
        f"final record {_finished(records)}")
    if (len(timeouts) != 1 or ledger != {"fired": [FT_STALL]}
            or not _finished(records)):
        failed.append(f"watchdog drill: {timeouts}, {ledger}")
    failed += _platform_failures(records, "watchdog drill")

    # 9c: two gloo ranks on the one card; rank 1 lost in epoch 1 (the world
    # shrinks to 1 with the global batch kept), a host back at epoch 2.
    code, lines = runs["elastic"]
    elastic_failed = _drill_failed("elastic drill", code, lines)
    records = _records(f"{el}.jsonl")
    starts = [r for r in records if r["kind"] == "run_start"]
    epochs = [(r["epoch"], r["batches"]) for r in records
              if r["kind"] == "epoch"]
    resizes = [l for l in lines if "launch: elastic" in l]
    contract = load_elastic_contract(el)
    log(f"[ft] 9c elastic: supervisor {resizes}; generations "
        f"{[(s['data_shards'], s['global_batch_size'], s['start_epoch']) for s in starts]}"
        f" (shards, global batch, start epoch); epoch records {epochs}; "
        f"elastic.json {contract}")
    if (len(resizes) != 2 or [s["data_shards"] for s in starts] != [2, 1, 2]
            or any(s["global_batch_size"] != 64 for s in starts)
            or contract != {"global_batch_size": 64, "world_size": 2}
            or [e for e, _ in epochs][-2:] != [1, 2]
            or len({b for _, b in epochs}) != 1 or not _finished(records)):
        elastic_failed.append(f"elastic drill: {resizes}, {starts}, "
                              f"{epochs}, {contract}")
    elastic_failed += _platform_failures(records, "elastic drill")
    return [f"9b: {f}" for f in failed] + [f"9c: {f}" for f in elastic_failed]


def check_vit_ema(torch, tmp) -> tuple[dict, list]:
    """Phase 9d: ViT-Tiny bf16 with --ema_decay --keep_best
    --max_checkpoints 1 → (B1-B3 launches, failures)."""
    import os

    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train import optim
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.trainer import ImageTrainer

    ckdir = f"{tmp}/vit_ema"
    # The fp64 recurrence over the card's parameters after every update,
    # with decay and 1 - decay as JAX's param_ema applies them (rounded to
    # fp32, EmaState.factors); the exact 0.999 beside it, a reading.
    d, w = optim.EmaState([], FT_EMA_DECAY).factors
    ref, exact, raw_calls, ema_evals = {}, {}, [], []
    real_step, real_eval = optim.Optimizer.step, ImageTrainer.evaluate_raw
    real_evaluate = ImageTrainer.evaluate

    def step(self):
        if self.ema_state is not None and id(self) not in ref:
            ref[id(self)] = [p.detach().double() for p in self.params]
            exact[id(self)] = [p.detach().double() for p in self.params]
        real_step(self)
        if self.ema_state is not None:
            new = [p.detach().double() for p in self.params]
            for r, (a, b) in ((ref, (d, w)),
                              (exact, (FT_EMA_DECAY, 1.0 - FT_EMA_DECAY))):
                torch._foreach_mul_(r[id(self)], a)
                torch._foreach_add_(r[id(self)], new, alpha=b)

    def evaluate_raw(self):
        ema = optim.ema_params(self.optimizer)
        raw_calls.append(all(torch.equal(p, e) for p, e in
                             zip(self.optimizer.params, ema)))
        return real_eval(self)

    def evaluate(self, **kw):
        out = real_evaluate(self, **kw)
        ema_evals.append(raw_calls[-1])  # the pass whose figures it returned
        return out

    launches = fl.flash_attention.launches
    _zero(launches)
    with _patched((optim.Optimizer, "step", step),
                  (ImageTrainer, "evaluate_raw", evaluate_raw),
                  (ImageTrainer, "evaluate", evaluate)):
        trainer, _ = _train(FT_DEVICE_ARGS + [
            "--checkpoint_dir", ckdir, "--ema_decay", str(FT_EMA_DECAY),
            "--keep_best", "--max_checkpoints", "1"], VIT_ARGS)
    torch.cuda.synchronize()
    got = {n: launches[f"{n}_bf16"] for n in FLASH_NAMES}
    ema = optim.ema_params(trainer.optimizer)

    def rel_err(want):
        num = sum(float((e.double() - r).pow(2).sum())
                  for e, r in zip(ema, want))
        return (num / sum(float(r.pow(2).sum()) for r in want)) ** 0.5

    rel = rel_err(ref[id(trainer.optimizer)])
    rel_exact = rel_err(exact[id(trainer.optimizer)])
    mgr = CheckpointManager(ckdir)
    kept = mgr.all_epochs()
    accs = [h["test_accuracy"] for h in trainer.history]
    best = int(np.argmax(accs))  # ties: the earliest, as the ranking keeps
    manifests = sorted(n for n in os.listdir(ckdir)
                       if n.endswith(".manifest.json"))
    saved = mgr.read(kept[-1])["opt_state"]["ema"]
    round_trip = all(torch.equal(s, e.cpu()) for s, e in zip(saved, ema))
    depth = len(trainer.state.model.block_names)
    steps = trainer.steps_per_epoch * trainer.config.epochs
    log(f"[ft] 9d ViT-Tiny bf16 --ema_decay {FT_EMA_DECAY}: EMA vs the fp64 "
        f"recurrence over the card's parameters, relative norm error "
        f"{rel:.3e} (limit {FT_EMA_TOL}; with the exact decay "
        f"{rel_exact:.3e}); evaluations on the EMA "
        f"{ema_evals}; test accuracy by epoch {accs}; kept epochs {kept}, "
        f"manifests {manifests}; EMA after the checkpoint round trip "
        f"{'bitwise equal' if round_trip else 'differs'}; launches {got} "
        f"(depth x steps = {depth * steps})")
    failed = []
    if not rel <= FT_EMA_TOL:
        failed.append(f"EMA off its fp64 recurrence: {rel:.3e}")
    if not ema_evals or not all(ema_evals):
        failed.append(f"evaluation not on the EMA: {ema_evals}")
    if kept != sorted({best, len(accs) - 1}) or manifests != [
            f"epoch_{e}.manifest.json" for e in kept]:
        failed.append(f"keep_best kept {kept} with {manifests}")
    if not round_trip:
        failed.append("the EMA changed through the checkpoint")
    if any(got[n] != depth * steps for n in FLASH_NAMES[1:]) or \
            got[FLASH_NAMES[0]] < depth * steps:
        failed.append(f"B1-B3 launches {got}")
    del trainer, ref, exact, ema
    torch.cuda.empty_cache()
    return got, failed


def check_pt_import(torch, tmp) -> list:
    """Phase 9e: a reference .pt (seeded weights, ``module.`` prefix) →
    the import CLI → logits on the card vs the CPU forward, then one epoch
    from the imported checkpoint → failures."""
    from ddp_tpu_torch.interop import import_torch_checkpoint as import_cli
    from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    pt, ckdir = f"{tmp}/epoch_0.pt", f"{tmp}/imported"
    state = {f"module.{k}": torch.from_numpy(v)
             for k, v in init_cnn_state(seed=5).items()}
    torch.save({"epoch": 0, "model": state, "optimizer": {
        "state": {}, "param_groups": [{"lr": 0.01, "params": list(range(6))}]}},
        pt)
    import_cli.main(["--pt", pt, "--checkpoint_dir", ckdir])
    params = CheckpointManager(ckdir).read_params(0)
    x = torch.from_numpy(np.random.default_rng(6).random(
        (256, 1, 28, 28), dtype=np.float32))
    cpu = SimpleCNN.from_state({k: v.numpy() for k, v in params.items()},
                               "cpu")
    dev = "cpu" if FT_DEVICE_ARGS else "cuda"
    card = SimpleCNN.from_state({k: v.numpy() for k, v in params.items()},
                                dev)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    trainer, out = _train(FT_DEVICE_ARGS + ["--checkpoint_dir", ckdir,
                                            "--epochs", "2"], FT_CNN_ARGS)
    losses = trainer.history[0]["loss"] if trainer.history else []
    tenth = max(1, len(losses) // 10)
    first, last = (float(np.mean(losses[:tenth])),
                   float(np.mean(losses[-tenth:]))) if losses else (0, 0)
    log(f"[ft] 9e reference .pt import: logits card vs CPU max |diff| "
        f"{err:.3e} (limit {FT_IMPORT_ATOL}); one epoch from it "
        f"({len(losses)} steps): mean loss of the first tenth {first:.4f}, "
        f"of the last {last:.4f}; resumed "
        f"{'Resumed from checkpoint epoch 0' in out}")
    failed = []
    if not err <= FT_IMPORT_ATOL:
        failed.append(f"imported logits differ: {err:.3e}")
    if not (losses and np.all(np.isfinite(losses)) and last < first
            and "Resumed from checkpoint epoch 0" in out
            and [h["epoch"] for h in trainer.history] == [1]):
        failed.append(f"the imported run did not train epoch 1 with a "
                      f"falling loss: {first} -> {last}")
    return failed


def check_fault_tolerance(torch, card) -> dict:
    """Phase 9, every reading printed before any raise → the B1-B3
    launches of 9a and 9d."""
    import tempfile

    t0 = time.perf_counter()
    seen = _sync_kinds(torch)
    failed, readings = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as tmp:
        steps = [("9a", lambda: check_lm_preemption(torch, tmp, seen)),
                 ("9b, 9c", lambda: ([], check_drills(torch, tmp))),
                 ("9d", lambda: check_vit_ema(torch, tmp)),
                 ("9e", lambda: ([], check_pt_import(torch, tmp)))]
        for label, run in steps:
            s0 = time.perf_counter()
            got, bad = run()
            readings[label] = got
            failed += [f"{label}: {b}" for b in bad]
            log(f"[ft] {label}: {time.perf_counter() - s0:.1f} s")
    log(f"[ft] phase 9: {time.perf_counter() - t0:.1f} s on {card}")
    if failed:
        raise AssertionError(f"phase 9: {failed}")
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
        _, engine = serve_run(torch, model, prompts, kv_dtype=kv_dtype)
        got = dict(launches)
        routed = dec.flash_decode_attention.plain_routed
        want = engine.decode_steps * spec.depth
        log(f"[serve] kv={kv_dtype} launches {got} (decode steps x depth "
            f"= {want}; all by graph replays: {engine.cuda_graphs}), routed "
            f"to the plain version by shape: {routed}")
        if engine.decode_attn != "flash" or got[name] != want or want == 0:
            raise AssertionError(f"{name}: {got[name]} launches != {want}")
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
    """A flash-decode kernel's mangled name → e.g. "split<int8,GT=4>",
    "split<fp32,GT=1,paged>" (B4p/B5p) or "merge<GT=1>"."""
    m = re.search(r"flash_decode_(split|merge)I([fa]?)Li(\d+)E(Lb1E)?",
                  mangled)
    if not m:
        return mangled[:60]
    kv = {"f": "fp32,", "a": "int8,", "": ""}[m.group(2)]
    paged = ",paged" if m.group(4) else ""
    return f"{m.group(1)}<{kv}GT={m.group(3)}{paged}>"


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
    import os
    import tempfile

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


def time_serve_steps(torch, model, *, kv_dtype, page_size=0, steps=40,
                     reps=4, **spec_kw) -> float:
    """Median host time (ms) of one steady engine step at 8 lanes, every
    lane decoding (prompts of 32 tokens, prefill done), over ``reps``
    windows of ``steps`` steps, each ended by a synchronize: the decode
    step latency free of arrival order. ``spec_kw`` (spec_tokens,
    draft_model) makes every step a speculative round."""
    knobs = {"page_size": page_size} if page_size else {}
    engine = steady_engine(torch, model, kv_dtype=kv_dtype, **knobs,
                           **spec_kw)
    times = []
    for _ in range(reps):
        before = engine.decode_steps
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps * 1e3)
        if engine.decode_steps - before != steps or engine.active != SLOTS:
            raise AssertionError("time_serve_steps: a timed step did not "
                                 "decode every lane")
    return float(np.median(times))


def time_serve_main(argv) -> int:
    """``--time-serve [--root DIR]``: the median steady decode step (ms)
    of the serving engine of the package under DIR (default: this
    script's tree) at phase 4's full width, 8 lanes, fp32 and int8 KV;
    paged too (page 16) where that tree serves paged, and one
    speculative round a step (fp32, phase 4d's truncated draft, γ 4)
    where it has spec_tokens. Run it on two
    trees in turns (parent, change, change, parent) within one call to
    compare them on one card."""
    import inspect

    import os
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--root" in argv:
        sys.path.insert(0, argv[argv.index("--root") + 1])
    from ddp_tpu_torch.models.lm import LMSpec, init_lm
    from ddp_tpu_torch.ops import _build
    from ddp_tpu_torch.serve.engine import ServeEngine

    root = str(_build.CSRC.parents[2])
    _build.build(("flash_decode.cu",))
    model = init_lm(LMSpec(**FULL), seed=0)
    knobs = inspect.signature(ServeEngine).parameters
    paged = "page_size" in knobs
    time_serve_steps(torch, model, kv_dtype="fp32", steps=8, reps=1)  # warm
    ms = {}  # fixed-lane first, in the same order on every tree
    for kv_dtype in ("fp32", "int8"):
        ms[kv_dtype] = round(time_serve_steps(torch, model,
                                              kv_dtype=kv_dtype), 3)
    for kv_dtype in ("fp32", "int8") if paged else ():
        ms[f"{kv_dtype}_paged"] = round(time_serve_steps(
            torch, model, kv_dtype=kv_dtype, page_size=SERVE_PAGE), 3)
    if "spec_tokens" in knobs:  # one speculative round a step
        from ddp_tpu_torch.models.lm import truncated_draft

        ms["fp32_spec"] = round(time_serve_steps(
            torch, model, kv_dtype="fp32", spec_tokens=SPEC_GAMMA,
            draft_model=truncated_draft(model, DRAFT_DEPTH)), 3)
    log(card_line())
    print(json.dumps({"root": root, "step_ms": ms}), flush=True)
    return 0


def time_flash_main(argv) -> int:
    """``--time-flash [--root DIR] [--dtype bf16|fp32|both]``: build
    flash_attn.cu of the package under DIR (default: this script's tree),
    print the card and one JSON line of B1-B3 times (µs) at the training
    shape, per dtype (default both). Run it on two trees in turns
    (parent, change, change, parent) within one call to compare them on
    one card."""
    import os
    import tempfile

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
    if "--time-serve" in sys.argv:
        return time_serve_main(sys.argv)
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
    paged_timings = check_paged_kernels(torch)
    launches = check_serving(torch)
    paged_launches = check_paged_serving(torch)
    spec_launches = check_spec_serving(torch, card)
    obs = check_serving_obs(torch, card)
    graphs = check_graphs(torch, card)
    moe = check_moe_serving(torch, card)
    check_moe_layer(torch)
    flash = check_flash(torch)
    trained, served = check_lm_phases(torch, card)
    check_cnn(torch, card)
    images = check_image_families(torch, card)
    fault = check_fault_tolerance(torch, card)

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
    # B4 is also the draft's decode attention on the speculative path
    # (phase 4d, truncated draft, fp32 and int8 target KV; phase 8c, the
    # trained draft, with phase 8d's named depth-2 engine).
    kernels[0]["spec_launches"] = spec_launches
    # Phase 4e (b): the truncated draft again, with request tracing on.
    kernels[0]["obs_spec_launches"] = obs["b4"]
    kernels[0]["trained_draft_launches"] = served["b4"]
    # B4p/B5p: library_ms is the gather then SDPA; gather_fixed_ms the
    # JAX design on the card (the gather, then B4/B5).
    kernels += [
        {"name": name, "route": "cuda",
         "source": "ddp_tpu_torch/ops/csrc/flash_decode.cu",
         "replaces": "ddp_tpu/ops/decode.py:371",
         "launches": paged_launches[name], **paged_timings[name]}
        for name in PAGED_NAMES
    ]
    # Phase 8b: B4p serving the trained checkpoint across the hot-swap.
    kernels[2]["lm_serve_launches"] = served["b4p"]
    # Phase 4e (a): B4p under every observability flag.
    kernels[2]["obs_launches"] = obs["b4p"]
    # Phase 4f: each decode kernel's launches inside CUDA graph replays
    # ((b)'s four runs; B4 also (e)'s draft steps). Phases 4-4e and 8
    # serve with graphs too: after warmup, or in-process from a
    # program's first (eager, counted) run on.
    for k in kernels:
        k["graph_launches"] = graphs["launches"].get(k["name"], 0)
    kernels[0]["graph_spec_launches"] = graphs["b4_spec"]
    # The MoE causal LM (decode_moe's width): phase 4g's graph runs (B4
    # fixed-lane fp32, B5 int8, B4p paged fp32), (d)'s draft steps (B4),
    # and phase 8f serving the trained MoE checkpoint (B4p).
    for k in kernels:
        k["moe_launches"] = moe["launches"].get(k["name"], 0)
    kernels[0]["moe_spec_launches"] = moe["b4_spec"]
    kernels[2]["moe_lm_serve_launches"] = served["moe_b4p"]
    # B1-B3: the bf16 variant is the main path (the causal-LM training
    # run's numbers); the fp32 variant's, from its own run, ride beside
    # them, and so do both at ViT-Tiny's shape (launches from phase 7a,
    # which runs bf16 only).
    for name in FLASH_NAMES:
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        vit_launches = {"bf16": images["vit"]["launches"][name], "fp32": 0}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ddp_tpu_torch/ops/csrc/flash_attn.cu",
            "replaces": replaces[name], "launches": trained["bf16"][name],
            # Phase 5m (the MoE LM, bf16) and 7c (vit_moe_tiny, bf16).
            "moe_launches": trained["moe"]["launches"][name],
            "vit_moe_launches": images["vit_moe"]["launches"][name],
            **{k: flash["bf16"][name][k] for k in keys},
            "sdpa_bwd_ms": flash["bf16"][name]["sdpa_bwd_ms"],
            # Phase 9: the LM's SIGTERM-and-resume (training launches over
            # both invocations) and ViT-Tiny with the EMA and keep_best.
            "fault_tolerance_launches": {"lm_preempt_resume":
                                         fault["9a"][name],
                                         "vit_ema": fault["9d"][name]},
            "variants": {
                "fp32": {"launches": trained["fp32"][name],
                         **{k: flash["fp32"][name][k] for k in keys}},
                **{f"vit_{d}": {"launches": vit_launches[d],
                                **{k: flash[f"vit_{d}"][name][k]
                                   for k in keys},
                                "sdpa_bwd_ms":
                                    flash[f"vit_{d}"][name]["sdpa_bwd_ms"]}
                   for d in ("bf16", "fp32")}},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
