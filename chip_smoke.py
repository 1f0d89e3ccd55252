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
   source, started together; phases 3-4h, which launch only the decode
   kernels, run beside flash_attn.cu's build, and phase 3b waits for
   it), print the build seconds and, from ptxas's
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
   d_model 1024, depth 4 (of 8: a cut), 8 heads, total_len 256) from
   seeded random
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
   first divergent token is below 1e-3). Then torch.profiler reads
   the device busy share of steady decode steps. Last, the flag runs:
   ``python -m ddp_tpu_torch.serve``'s main() with --prefill_chunk 32
   --min_bucket 8 --step_token_budget 40 (SERVE_FLAGS) serves the same
   ten requests in fp32 (--decode_attn flash), int8 and paged fp32:
   every request complete; compile_counts() after the traffic equal to
   its value after warmup() and to FLAG_COMPILE_COUNTS (JAX's warmup()
   for these flags, pinned by tests/test_torch_serve_flags.py); the run's
   kernel launched decode steps x depth times and no other; fp32 greedy
   streams equal the default-flag run's, parted only at a near tie
   (counted; int8 streams counted, not gated: another chunk split is
   another int8 computation). A small model with --decode_attn reference
   --max_queue 2 answers a burst of 16 with 429s and launches no decode
   kernel.
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
   them in one step. With ``truncated_draft(model, DRAFT_DEPTH)`` (the
   target's first half, bench.py's zero-training draft), fp32 and int8
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
   run_lm_bench's width, T 2048, batch 8, Adam 3e-4, bf16) at depth 4, 12
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
   trained through main() at run_lm_bench's width, depth 2, with
   --moe_experts 8
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
   --model simple_cnn``'s own main() on a synthetic split of a quarter
   of MNIST's size (15,000 / 2,500: a cut), SimpleCNN at full width (32,
   64), world 1 over nccl, SGD 0.01 with momentum 0.9 (so the restored optimizer
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
   ddp_tpu_torch.train``'s own main(), on synthetic splits of 6,400
   images (ResNet-18's 3,200), world 1 over nccl; vit_moe_tiny at depth
   4.
   7a: ViT-Tiny on CIFAR-100 (configs 4; bench.py run_vit_bench's model,
   batch 256 and SGD 0.01 + momentum 0.9, bf16, crop-and-flip), 2 epochs:
   launch counters set to 0 before and read after (each of B1-B3 at
   least depth x steps in bf16, nothing routed to the plain block),
   losses finite and falling, epoch_0..1 verified and a re-run resuming
   epoch 1's state bit for bit, one step through the kernels vs the
   plain attention from the trained weights (fp32: STEP_TOL against the
   exact step; bf16: BF16_GATE_RATIO against SDPA's distance from it and
   VIT_BF16_LOSS_TOL; a B1 that counts the zero-filled keys 65-127 and a
   B3 that drops key row 64 must fail it); step p50, images/s per card, est. MFU and
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
   spec_skew; the served prompts' last-position logits equal
   train_forward's (fp32, at capacity factor E/k, where no token can
   drop: every prompt compares, and none compared fails) within
   MOE_LOGITS_ATOL. 5m's checkpoint is removed at the end.
9. The trainer's fault tolerance (check_fault_tolerance; every command
   on the card, every generation's run_start naming it).
   9a: phase 5's LM at run_lm_bench's width, depth 2 (bf16, 2 epochs of 6
   steps)
   through main(): the uninterrupted command twice (bitwise equal, or
   their spread logged); the same under --chaos sigterm:rank0@step8
   exits clean with epoch 1 saved at mid_batch 2 (the save's seconds
   printed); the re-run resumes it (seconds from the call to the first
   resumed step's end printed) and ends on the uninterrupted run's
   parameters and Adam state (bitwise, or within the spread); B1-B3
   launched in training steps x depth over the two invocations (the
   evaluations' B1 counted apart); the control, re-entering one batch
   late, must fail the comparison; 8 steady LM steps make no
   synchronizing call, with the watchdog, a chaos engine and the SIGTERM
   handler armed and with none (sync debug mode "warn" plus wrappers:
   0), and raise nothing under the mode "error", where one .item() a
   step (the control) must raise; the asynchronous save: save()'s hold
   of the loop against the blocking save, wait(), the step p50 right
   after a save against none, the epoch restoring the state at save()
   bit for bit, the manifest read before the commit (and a writer that
   skips that wait caught), a process that returns right after save()
   leaving a verified epoch with the saved state's digest; the steady
   step without and with the parameter EMA, timed in turns (a
   reading).
   9b: SimpleCNN on the reference's path (--epochs 3 --batch_size 64,
   SGD 0.01) on 3,200 synthetic MNIST images, --deterministic, each run
   under the supervisor: two uninterrupted runs; --max_restarts 1 --chaos
   kill:rank0@step75 (the supervisor logs "killed by SIGKILL",
   relaunches, and the run ends on the uninterrupted state by the same
   rule; kill to the next run_start printed); ckpt_corrupt:latest on
   that directory (epoch 2 quarantined, a fallback record, epoch 2
   retrained from epoch 1); --watchdog_timeout 5 --max_restarts 1 --chaos
   stall:input@step62:30s (one exit 124 classified as a watchdog
   timeout, the run completes, the stall in the ledger once).
   9c: --spawn 2 --backend gloo --elastic --min_world 1 --max_restarts 2
   --chaos shrink:rank1@step75,grow:+1@epoch2 on the one card: worlds
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
10. The ImageNet family at 224² on the synthetic set (check_imagenet),
   written once as the memory-mapped arrays --dataset imagenet reads.
   10a: ResNet-50 (ImageNet stem) in bf16 and fp32 through main() on the
   loader path with --num_workers 2: the native pool's batch counter =
   the steps, losses falling, the bf16 resume exact, the pool's batches
   bit for bit the Python gather's, one fp32 step on the card against
   the CPU's fp64 step at batches 2 and 4 from the trained weights (ReLU
   masks tied, CNN_STEP_TOL; the seeded ones in --step-spread; the step
   without the blocks' conv gradients must fail). 10b: ViT-Tiny at 224²
   (T 3137: the last key tile holds 65) in bf16: B1 = B2 = B3 = depth x
   steps in training (evaluation apart), nothing routed, resume exact,
   one step through the kernels vs the plain attention at batch 8: fp32
   within STEP_TOL of the exact step; bf16 within BF16_GATE_RATIO of
   SDPA's distance from it, the loss within VIT_BF16_LOSS_TOL of the bf16
   plain step (STEP_TOL's old reading printed); key row 3136's dK/dV
   too; a B1 that counts the last tile's zero-filled keys and a B3 that
   drops key row 3136 must fail it.
   10c: --remat: the step equals the step without (bf16 ViT, fp32
   ResNet-50), remat lowers peak memory, and a --remat run launches B1
   2 x depth x steps. 10d: --profile_dir's trace names B1's kernel. 10e:
   --no_shuffle's first batch is rows 0..63, --num_classes sizes the
   head. 10f: B1-B3 alone at B 32, T 3137, H 3, D 64, bf16 and fp32,
   held to FLASH_TOL and timed with their bounds and SDPA.
11. The long-context slice (check_long_context). 11a: the long-context
   classifier at full width (LC_ARGS: d 64, depth 2, 4 heads so head dim
   16, T 8192, batch 32, non-causal; 2 epochs of 4 steps) through main()
   in bf16 and fp32: B1 = B2 = B3 = depth x steps in training in the
   run's dtype (evaluation apart), nothing routed, losses falling, resume
   exact; step p50, sequences/s, tokens/s, busy share, B1-B3's share of
   device time; a --seq_strategy ulysses epoch launches the same
   kernels. 11b: one step through B1-B3 against the plain attention at
   batch 2 (fp32 STEP_TOL; bf16 the gate BF16_GATE_RATIO against SDPA's
   distance from the exact step; key row 8191's dK/dV), a B3 that drops
   that row must fail, and a B3 that drops the dK of keys 512-575 must
   fail the bf16 gate itself (and the fp32 limits). 11c: B1-B3 alone at B 32, T 8192, H 4, D 16
   (FLASH_TOL at B 2; timed with the bound, SDPA, the plain version in
   chunks, and the exponentials as a reading) and at 11d's shape. 11d:
   the causal LM at bench.py run_lm_long_bench's shape (vocab 8192, d
   1024, depth 4 (of 8: a cut), 8 heads, T 8192, batch 2, bf16, 4
   steps): launches,
   tokens/s, step p50, est. MFU; one step at depth 2 kernel vs plain
   (the bf16 gate, the fp32 kernel step against the exact one, a dropped
   dK tile must fail), peak memory. 11e: --dataset text on README.md at
   --vocab_size 1024: tokenizer.json byte-identical to a --device cpu
   run's, reused on resume, loss falling. 11f: the LM at run_lm_bench's
   width (vocab 8192, d 1024, 8 heads, T 2048; depth cut to 2, 4 steps,
   fp32, SGD) at --spawn 2 --backend gloo (both ranks on the one card,
   batch 2 each) against two world-1 runs of the same global batch
   (batch 4; 2 x accumulation 2), within their distance; a world-2
   average divided twice must not be; rank 0's --profile_dir trace
   counts its B1-B3 launches.
12. The sequence models across ranks (check_mesh), every rank a process
   on the one card through --spawn N --backend gloo (exchanges staged
   through pinned host memory; step times are N processes sharing one
   card, no scaling figure; the runs in one wave, half of them
   WAVE_STAGGER s after the rest): 12a long_context
   at README's command (--mesh_seq 4; T 8192, batch 32, bf16; one epoch
   of 2 steps), ring and Ulysses; 12b the LM at run_lm_long_bench's
   width (d 1024, 8 heads, T 8192, batch 2, bf16; depth cut to 2, 2
   steps) at --mesh_seq 2 (causal: rank 0 one block call a layer, rank
   1 two), --mesh_model 2 and both (world 4); 12c phase 5m's routed LM
   (8 experts, top-2; depth cut to 2, 2 steps of 8 a replica) at
   --mesh_expert 2. Each rank's --profile_dir trace gives its B1-B3
   launches in training (the hop schedule: none routed, none in fp32),
   its step p50 and busy share; rank 0's --metrics_file where the run's
   wall time went (start-up, training, evaluation and checkpoint, the
   rest of the runs). A run past P12_RUN_TIMEOUT fails. The ring hops'
   blocks ([32, 2048, 4, 16] and [2, 4096, 8, 128], non-causal) held to
   their plain versions and timed with SDPA. 12d: one fp32 step of each
   mesh through B1-B3 (a gloo world of 4 processes on the card, beside
   the runs; if it fails, or hangs past P12D_DEADLINE s from its start,
   it is killed and fails every check) against the world-1 exact step
   (the plain attention) within STEP_TOL["fp32"], at depth 2 and batch 2
   (long_context), 1 a replica (the LM at T 4096, and the routed LM,
   the latter against world 1 on each replica's rows with the routing
   held); a
   dropped past hop, a model reduction counted twice and slots sent to
   the wrong owner must fail it; and --mesh_seq 2 --spawn 2 against
   world 1 after 2 fp32 SGD steps (W2_ARGS's width) within
   P12_PARAM_ATOL, a gradient divided by the world once more outside.
13. FSDP and ZeRO, in phase 12's wave and 12d's world: 13a the LM at
   12b's width (T 8192, bf16, depth 2, a sequence a rank) at --mesh_fsdp
   2 --mesh_seq 2 --spawn 4; 13b ViT-Tiny at 7a's width (T 65, bf16, 64
   images a rank) under --parallel zero --zero_gather_dtype bf16 --spawn
   2; each rank's launches (the hop schedule; 12 a step for ViT), its
   bytes of parameters and optimizer state at rest against the shard
   specs and the bucket layout (13a against 12b_seq2's), 13b's
   comm_bytes against zero_comm_bytes. 13c in 12d's world: one fp32 step
   of the LM (cut to T 2048) at fsdp 2 x seq 2, fsdp 2 x model 2 and data
   2 x fsdp 2, under zero at data 4 and data 2 x model 2 (the clip
   engaged), and of ViT-Tiny under zero at data 4 with the fp32 and the
   bf16 gather, against world 1's exact step (STEP_TOL["fp32"]; ViT's
   updated parameters within P12_PARAM_ATOL; the bf16 master against the
   fp32 gather's parameters); the reduce-scatter's 1/n dropped, the
   clip's model sum doubled and the neighbour's shard offset must fail.
14. GSPMD for the image family (check_mesh, in phase 12's wave and 12d's
   world): 14a ViT-Tiny at 7a's width (CIFAR-100, T 65, d 192, depth 12,
   3 heads, bf16) at --mesh_model 3 --spawn 3: every rank's B1 = B2 = B3
   = depth x steps in training, all on [64, 65, 1, 64] (one head a
   rank), none in fp32; its bytes at rest the specs'; rank 0's
   checkpoint restored by a world-1 run to the same parameters, bit for
   bit. 14b vit_moe_tiny at --mesh_expert 2 --spawn 2 (launches by rank,
   4 experts a rank at rest); 14c ResNet-18 on CIFAR-10 at --mesh_fsdp 2
   and under --zero1 (--spawn 2 each): parameters and momentum at rest
   against the specs, finite losses. 14d in 12d's world: one fp32 step
   of ViT-Tiny at model 2 x fsdp 2 (3 heads: qkv gathered), vit_moe_tiny
   at expert 2 x data 2 (capacity factor P14_MOE_CF: tokens drop, the
   count printed), ResNet-18 at fsdp 4 (synchronized BN), simple_cnn and
   ViT-Tiny under --zero1 at data 4, against world 1's exact step on the
   same global batch (STEP_TOL["fp32"]; the MoE's global routing and the
   ResNet's ReLU masks held; --zero1's updated parameters within
   P12_PARAM_ATOL); BN by the rank's own moments, MoE capacity and slots
   per rank, an fsdp gradient unscaled by its axis and a --zero1 update
   without the parameter all-gather must fail. 14e in the same world:
   shard_decode_attention at model 2 and 4, B4 and B5, S 8, H 8, H_kv 8
   and 2, Dh 128, L 256 and 8192, every lane at L-1: one launch a rank on
   its heads, the gathered heads bitwise the world-1 kernel's and within
   KERNEL_ATOL of the plain version's, H_kv 2 at model 4 JAX's
   whole-head call (counted), an off-by-one head offset failing. B1-B3
   alone at 14a's shape [64, 65, 1, 64], timed with their bound and
   SDPA.
15. The in-graph pipeline (check_mesh: its runs a second wave, started
   after phase 12's wave and the kernel timings, beside 12-14's checks —
   the first wave alone peaks at ~75 GB of the card's 80, and one wave of
   both died of CUDA's out of memory — and 15c/15d in 12d's world): 15a
   pipe_lm at run_lm_bench's width (vocab 8192, d 1024, 8
   heads of 128, T 2048, batch 8, M 4, bf16, Adam) at --mesh_pipe 2,
   --model_depth 4 under 1f1b (8 blocks), 2 under gpipe and
   --virtual_stages 2 --model_depth 1 under interleaved (4 blocks: a
   cut); 15b pipe_vit at ViT-Tiny's width
   (CIFAR-100 synthetic, d 192, 3 heads, T 64) at --mesh_pipe 2
   --model_depth 6, batch 256, M 8, 1f1b, --augment crop_flip, bf16 input
   (fp32 compute, as JAX's pipe_vit promotes: its B1-B3 are the fp32
   kernels); each --spawn 2 over gloo, 2 steps and the evaluation. Every
   rank's B1-B3 launches in training equal its timetable's count (M x v
   x depth a step, B1 twice under 1f1b and interleaved: the backward slot
   rebuilds the chunk), none in the other dtype (nothing routed); finite
   losses; 15a's checkpoint restored bit for bit by each pipe rank, and
   its to_dense_lm through CausalLM gives the pipeline's eval loss within
   P15_DENSE_ATOL. Readings: step p50, busy share and the bubble
   fraction. 15c in 12d's world: one fp32 step of pipe_lm (P15_LM: d
   1024, T 1024, one block a chunk) at pipe 2 x data 2 under each
   schedule and at pipe 4 with v 2, and of pipe_vit under 1f1b, against
   world 1's exact sequential step (STEP_TOL["fp32"]); a 1F1B backward
   dropped at stage 0, the tied embedding without the head's part and
   interleaved chunks placed stage-major must fail it. 15d: stage 0's
   peak allocated memory over a 1F1B step at M 16 within
   P15_MEMORY_RATIO of its peak at M 4 (microbatches of one row), GPipe's
   two peaks printed beside. B1-B3 alone at 15a's microbatch [2, 2048, 8,
   128], causal, timed with their bound and SDPA.
16. The pipe family's compositions (check_mesh: 16a in phase 15's second
   wave, the wave's peak of the card's used memory read every second and
   printed; 16c in 12d's world): 16a pipe_lm at 15a's width at README's
   PP x TP command (--mesh_pipe 2 --mesh_model 2 --model_depth 4
   --pipe_schedule 1f1b --num_microbatches 8), at PP x SP (--mesh_seq 2
   --seq_strategy ulysses --model_depth 2 --pipe_schedule interleaved
   --virtual_stages 2) and PP x EP (--mesh_expert 2 --model_depth 4
   --moe_experts 8 --moe_every 2, gpipe, top-2), and pipe_vit at 15b's
   width at --mesh_fsdp 2 --fast_epoch; each --spawn 4 over gloo, 2 steps
   and the evaluation. Every rank's B1-B3 launches in training equal its
   timetable's count, all on its composition's q (P16_Q: [1, 2048, 4,
   128] under PP x TP), none routed, none in the other dtype; each rank's
   bytes of parameters and optimizer state at rest the specs'
   (pipe_common.stage_specs: 4 experts a rank under PP x EP, the fsdp
   shards of pipe_vit); finite losses; the PP x TP checkpoint restored at
   --mesh_pipe 2 (no model axis) by each pipe rank to the file's full
   state, bit for bit. Readings: step p50, busy share, the bubble
   fraction. 16c in 12d's world: one fp32 step of pipe_lm (P15_LM) at pipe
   2 x fsdp 2 (gpipe, 1f1b), pipe 2 x model 2 (1f1b, interleaved v 2),
   pipe 2 x expert 2 (every block routed over 4 experts at capacity factor
   E/k: drops counted, 0), pipe 2 x seq 2 (Ulysses under 1f1b, the ring
   under gpipe), and of pipe_vit at pipe 2 x model 2 (d 192, 2 heads of
   96) and pipe 2 x fsdp 2 (1f1b), against world 1's exact sequential
   step (STEP_TOL["fp32"]); a stage gradient scattered over fsdp unsummed,
   the rebuilt 1F1B chunk's f without its all-reduce, an expert leaf
   summed over expert and stage 0's positions without the seq offset must
   fail it. B1-B3 alone at 16a's PP x TP microbatch [1, 2048, 4, 128],
   causal, timed with their bound and SDPA.
17. A "kernels" JSON line (each decode kernel's launches on the MoE path,
   moe_launches, beside its own, and in phase 4's flag runs,
   flag_launches; B1-B3's in 5m and 7c, phase 9's as
   fault_tolerance_launches, phase 10's as imagenet_launches, phase
   11's as long_context_launches, lm_long_launches and
   lm_world2_rank0_launches, phases 12's, 13's and 14's as
   mesh_launches_by_rank, 14a's and 14b's as gspmd_launches_by_rank,
   14e's decode launches as shard_decode_launches_by_rank, phases 15's
   and 16a's as pipe_launches_by_rank, and
   their timings at T 3137, at the long-context shape, at the LM's T
   8192, at the ring hops' shapes, at 14a's, at 15a's and at 16a's as the
   vit224_*, long_context_*, lm_long_*, hop12a_*/hop12b_*, vit14a_*,
   pipe15a_* and pipe16_* variants),
   the card line, and the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Cuts for the time limit (each at its constant): phase 5 at depth 4, 5m,
8f and 9a at 2, 7c at 4, 9b/9c and 7b on half their sets, 4f/4g timing
32 steps a turn, 13c's LM at T 2048 (before phase 14); with phase 14:
the serving phases 4-4g at depth 4 (FULL, of 8), 11d's LM at depth 4,
6a on 15,000 images, 7a/9d on 6,400 and 7b on 3,200, phase 10 on 1,024 (10a 16 steps
an epoch, 10b 32), 9b/9c on 3,200 images, 10a's fp64 step gate from
the trained weights only (--step-spread reads the seeded weights too: a
reading, not a gate), B1-B3's timings at 2 turns after 2 warm calls (fp32 at 3
calls a turn), the fast path's timing at batch 64 on 6,400 images
(TIME_FAST_SIZE) and 4h's at 2
turns of 2, 12d's LM at T 4096 (of 8192); with phase 15: its runs at 2
steps each, 15c's LM at T 1024 (of 2048) and one block a chunk; with
phase 16: 15a's gpipe and interleaved runs at 4 blocks (of 8), 16a's at
2 steps each, 16c's at 15c's sizes.
No kernel's
check against its plain version and no path is cut.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
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
FULL = dict(vocab_size=8192, total_len=256, d_model=1024, depth=4,
            num_heads=8)
SLOTS, PREFILL_LEN = 8, 128
# Phase 4's flag runs: the scheduler flags at values phase 4 never
# serves with (chunk 32, buckets {8, 16, 32}, 40 tokens a step), and the
# compile contract JAX's warmup() gives for them at SLOTS and PREFILL_LEN
# (tests/test_torch_serve_flags.py pins it).
SERVE_FLAGS = ["--prefill_chunk", "32", "--min_bucket", "8",
               "--step_token_budget", "40"]
FLAG_COMPILE_COUNTS = {"prefill_first": 3, "prefill_chunk": 3, "decode": 1}
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


def _kineto(torch, *, cpu: bool = True):
    """A Kineto profiler of the card's kernels (and the CPU's ops with
    ``cpu``): ``torch.autograd.profiler.profile``, whose context gives
    ``key_averages()`` as ``torch.profiler.profile``'s does, without the
    latter's start importing the compiler stack (``hasattr(torch,
    "_inductor")``: ~6-8 s of CPU a process on an H100 80GB HBM3 host at
    700 W)."""
    from torch.autograd import profiler as autograd_profiler

    return autograd_profiler.profile(use_device="cuda", use_cpu=cpu,
                                     use_kineto=True)


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


def _median_ms(torch, fn, *, n=50, reps=7, warm=5):
    """Median device time of one call, from CUDA events around ``n``
    back-to-back calls (after ``warm`` untimed ones). A sleep kernel
    queued first keeps the card busy while the host enqueues, so host
    overhead does not show as idle device time (the sleep is lengthened
    until it covers the enqueue)."""
    for _ in range(warm):
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
    # The long-context classifier's attention (phase 11) at batch 2: head
    # dim 16 in the kernels' 64-column head tile, 64 key tiles.
    ("long_context non-causal T=S=8192 D 16", 2, 8192, 8192, 4, 16, False),
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
                shape=("the training shape",) + TRAIN_SHAPE,
                plain_batch=None) -> dict:
    """Kernel, plain version and SDPA times at a main path's shape: the
    causal LM's training step (B 8, T = S 2048, H 8, D 128, causal),
    ViT-Tiny's (VIT_SHAPE) or a long one. ``plain_batch``: the plain
    version runs over the batch in chunks of that many (its [B, H, T, S]
    fp32 logits would not fit the card at once); its time is the whole
    batch's."""
    label, B, T, S, H, D, causal = shape
    q, k, v, dout, _ = _flash_inputs(torch, B, T, S, H, D, dtype, seed=99)
    out, lse = fl.flash_forward(q, k, v, causal)
    delta = fl.backward_delta(out, dout)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    # Timing repeats (cut to 2 turns after 2 warm calls, fp32 to 3 calls
    # a turn, since phase 14 joined the script).
    n, reps, warm = (10, 2, 2) if dname == "bf16" else (3, 2, 2)
    kernel = _kernel_calls(fl, q, k, v, dout, lse, delta, causal)
    step = plain_batch or B

    def chunked(fn, *args):
        def run():
            for b in range(0, B, step):
                fn(*(a[b:b + step] for a in args), causal)
        return run

    plain = {
        "flash_attn_fwd": chunked(fl.attention_with_lse_reference,
                                  qf, kf, vf),
        "flash_attn_dq": chunked(fl.flash_dq_reference,
                                 qf, kf, vf, df, lse, delta),
        "flash_attn_dkv": chunked(fl.flash_dkv_reference,
                                  qf, kf, vf, df, lse, delta),
    }
    # The yardstick: SDPA forward, and its backward (dq, dk and dv in one
    # call), on the same tensors in [B, H, T, D]; timed only.
    qs, ks, vs = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    sdpa_fwd_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal), n=n, reps=reps, warm=warm)
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    do_s = dout.transpose(1, 2)
    sdpa_bwd_ms = _median_ms(torch, lambda: torch.autograd.grad(
        o_s, (qs, ks, vs), do_s, retain_graph=True), n=n, reps=reps,
        warm=warm)
    if dname == "fp32" and shape[1:] == TRAIN_SHAPE:
        _log_sdpa_numerics(torch, F, fl, qs, ks, vs, qf, kf, vf)
    pairs, nbytes = _flash_counts(B, T, S, H, D, causal, q.element_size())
    res = {}
    for name in FLASH_NAMES:
        ms = _median_ms(torch, kernel[name], n=n, reps=reps, warm=warm)
        plain_ms = _median_ms(torch, plain[name], n=1 if plain_batch else 2,
                              reps=reps, warm=warm)
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
    with _kineto(torch, cpu=False) as prof:
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
    with _kineto(torch) as prof:
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
SPEC_GAMMA, DRAFT_DEPTH = 4, FULL["depth"] // 2
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


def _timeline_failures(doc, prompt_len, reply, label) -> list[str]:
    """One completion's /requestz timeline: it validates, its prefill
    tokens are the prompt minus the prefix hit, its decode tokens the new
    tokens minus the first, and it retires complete."""
    from ddp_tpu_torch.obs.reqtrace import (
        requestz_events,
        validate_request_timeline,
    )

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

# (d): steady decode steps timed a turn (64 until phase 13 joined the
# script: a cut for its time).
GRAPH_STEPS = 32
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


def _laps(tag):
    """``lap(label)`` logs the seconds since the last lap (or the call),
    tagged: where a phase's time goes."""
    mark = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        log(f"[{tag}] {label}: {now - mark[0]:.1f} s")
        mark[0] = now

    return lap


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
    lap = _laps("graphs")
    warm, failed = check_graph_warmup(torch, model, draft)
    lap("warmup")
    launched, bad = check_graph_streams(torch, model, prompts)
    failed += bad
    lap("streams")
    spec_readings, bad = check_graph_spec(torch, model, prompts, draft)
    failed += bad
    lap("spec")
    failed += check_rebound_weight(torch, prompts)
    lap("rebound weight")
    timing = time_graph_steps(torch, model, card)
    lap("timing")
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
    DRAFT_DEPTH)`` (its routed blocks) through the draft_decode and
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
    if not routed or routed != [i + 1 for i in range(DRAFT_DEPTH)
                                if model.spec.routed(i)]:
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
                            torch, layer, x, dy, f, dt), n=2, reps=2,
                            warm=2)
    del layer
    log(f"[moe] (4h) fwd+bwd ms at n {c['n']}, cf 2.0 (route, dispatch, "
        f"FFN, combine, backward): {readings}")
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 4h: {failed}")
    return readings


# ---- phase 5: the training slice end to end ----------------------------

# The repo's full-width training configuration (bench.py run_lm_bench:
# vocab 8192, d_model 1024, 8 heads, T 2048, batch 8, Adam 3e-4, bf16
# compute) at depth 4 of its 8 (a cut for the script's time since phase
# 13 joined it): 48 sequences = 6 steps per epoch, an eval of 8.
TRAIN_ARGS = [
    "--model", "causal_lm", "--dataset", "synthetic_seq",
    "--synthetic_size", "48", "--seq_len", "2048", "--vocab_size", "8192",
    "--model_dim", "1024", "--model_depth", "4", "--num_heads", "8",
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
# to bf16 for their products, the plain version does not (phase 5 holds
# these limits; 7a, 7c, 10b and 11 hold BF16_GATE_RATIO and print them as
# a reading); fp32: summation order only.
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
        return _replayed(torch, old, tokens, router_weight, router_bias,
                         num_experts, normalize_gates)

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def _replayed(torch, old, tokens, router_weight, router_bias, num_experts,
              normalize_gates):
    """A recorded routing ``old`` (its experts, slots and kept
    assignments, on any device) on ``tokens``: its gates and aux loss
    recomputed from this router."""
    dev = tokens.device
    expert, kept = old.expert.to(dev), old.kept.to(dev)
    gates = torch.softmax(torch.nn.functional.linear(
        tokens.float(), router_weight.float(), router_bias.float()), -1)
    gate = torch.stack([gates.gather(-1, e[:, None])[:, 0]
                        for e in expert]) * kept
    if normalize_gates:
        gate = gate / torch.clamp(gate.sum(0, keepdim=True), min=1e-9)
    first = (expert[0][:, None]
             == torch.arange(num_experts, device=dev)).float()
    aux = num_experts * torch.sum(gates.mean(0) * first.mean(0))
    return old._replace(expert=expert, slot=old.slot.to(dev), kept=kept,
                        gates=gate, aux=aux)


def _step_grads(torch, trainer, toks, block_fn, compute_dtype=None):
    """One Adam step from the trainer's current weights on ``toks`` in
    ``compute_dtype`` (None: the trainer's) → (loss, {parameter name:
    gradient})."""
    from ddp_tpu_torch.models.lm import CausalLM, make_lm_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    state = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    model = CausalLM.from_state(trainer.spec, state, trainer.device,
                                trainable=True)
    opt = make_optimizer(model.parameters(), "adam", lr=3e-4)
    step = make_lm_train_step(
        model, opt, compute_dtype=compute_dtype or trainer.compute_dtype,
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
    attn = {n: e for n, e in per.items() if ".attn." in n} or {"-": 0.0}
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


def compare_step(torch, trainer, dname, *, batch=2, gate="step_tol") -> dict:
    """One Adam step from the trainer's current weights on its first
    ``batch`` sequences, through the kernels and through the plain
    attention (which must launch nothing), held to STEP_TOL. Then a
    negative control that the same limits must reject: the plain
    attention with the dK of one 64-key tile (keys 512-575) dropped, as a
    B3 that skipped a tile would give. In bf16 one more reading, for
    information only: an attention computed in bf16 throughout (S,
    softmax and P·V) lands next to the kernel's own bf16 rounding here,
    so no limit can tell the two apart.

    ``gate="ratio"`` (phase 11d, bf16): the kernel step is held to
    BF16_GATE_RATIO against the exact step (fp32, plain attention),
    measured by the same bf16 step through SDPA, with the loss within
    STEP_TOL["bf16"]["loss"] of the bf16 plain step (the old reading
    against that step printed), and the dK/dV of the control's keys
    512-575 in every block within STEP_TOL["bf16"]["attn"] of the plain
    step's (at T 8192 one tile moves the leaves by less than bf16 does);
    the fp32 kernel step is held to STEP_TOL["fp32"] against the exact
    step; the control must fail. Returns the peak memory of the kernel
    and plain steps (MB)."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.parallel.ring import default_block_fn

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

    def sdpa(q, k, v, causal):
        return _sdpa_attention(torch, causal)(q, k, v), None

    toks = trainer.tokens[:batch]
    tol = STEP_TOL[dname]
    ratio = gate == "ratio" and dname == "bf16"
    routes, flips = [], []
    peak = {}

    tile = {}  # label → the dK/dV rows of keys 512-575 a block (ratio)

    def grads(block_fn, label, dtype=None):
        if ratio:
            tile[label] = []
            block_fn = _tail_rows(torch, block_fn or default_block_fn,
                                  tile[label], slice(512, 576))
        torch.cuda.reset_peak_memory_stats()
        with fixed_routing(torch, routes, flips if label == "plain" else []):
            out = _step_grads(torch, trainer, toks, block_fn, dtype)
        peak[label] = torch.cuda.max_memory_allocated() / 2**20
        return out

    kernel = grads(None, "kernel")
    if ratio:  # the fp32 kernel step, before the counters go to 0
        fp32 = grads(None, "kernel fp32", torch.float32)
    _zero(fl.flash_attention.launches)
    plain = grads(fl.attention_with_lse_reference, "plain")
    e = _grad_errors(kernel, plain)
    log(f"[train] {dname} one step, kernel vs plain attention (batch "
        f"{batch}): loss {kernel[0]:.6f} vs {plain[0]:.6f}; {_errors_text(e)} "
        f"(tolerances {tol}{'; the old reading' if ratio else ''}); peak "
        f"memory {peak['kernel']:.0f} / {peak['plain']:.0f} MB"
        + (f"; routing held to the kernel step's, routed blocks' own "
           f"choices would differ at {flips} of {toks.numel() * 2} "
           f"(token, k) per block" if routes else ""))
    if ratio:
        exact = grads(fl.attention_with_lse_reference, "exact",
                      torch.float32)
        e_sdpa = _grad_errors(grads(sdpa, "sdpa"), exact)

        def passes(got, label):
            g = _bf16_gate(_grad_errors(got, exact), e_sdpa)
            loss = _grad_errors(got, plain)["loss"]
            rows = _tail_error(torch, tile[label], tile["plain"])
            return (g["ok"] and loss <= tol["loss"] and rows <= tol["attn"],
                    f"{_gate_text(g)}, loss rel {loss:.2e} vs the bf16 plain "
                    f"step (limit {tol['loss']}), keys 512-575's dK/dV in "
                    f"every block rel {rows:.2e} (limit {tol['attn']})")

        ok, text = passes(kernel, "kernel")
        log(f"[train] bf16 gate: {text}; SDPA bf16 vs exact: "
            f"{_errors_text(e_sdpa)}")
        failed = [] if ok else ["the kernel step fails the bf16 gate"]
        e32 = _grad_errors(fp32, exact)
        del fp32
        log(f"[train] fp32 one step, kernel vs exact: {_errors_text(e32)} "
            f"(tolerances {STEP_TOL['fp32']})")
        if not _within(e32, STEP_TOL["fp32"]):
            failed.append("the fp32 kernel step disagrees")
    else:
        failed = [] if _within(e, tol) else ["the kernel step disagrees"]
    del kernel
    dropped = grads(dropped_dk, "control")
    if ratio:
        caught, text = passes(dropped, "control")
        caught = not caught
    else:
        text = _errors_text(_grad_errors(dropped, plain))
        caught = not _within(_grad_errors(dropped, plain), tol)
    del dropped
    log(f"[train] {dname} control, dK tile dropped: {text}")
    if not caught:
        failed.append("the check passes a B3 that drops a dK tile")
    if dname == "bf16":
        low = grads(low_precision, "low")
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
    return {"kernel_mb": peak["kernel"], "plain_mb": peak["plain"]}


def profile_train_steps(torch, trainer, *, steps=3) -> None:
    """Device busy share of steady training steps from torch.profiler:
    summed CUDA kernel time over the wall time of ``steps`` steps, and
    the top kernels."""
    B = trainer.config.batch_size
    batches = [trainer.tokens[i * B:(i + 1) * B] for i in range(steps + 1)]
    trainer.runner.step(batches[0])  # warm
    torch.cuda.synchronize()
    with _kineto(torch) as prof:
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
    """Seconds of each ``CheckpointManager.save`` call inside the block:
    what it holds the loop (an asynchronous save writes on after it)."""
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
        f"({_dir_bytes(ckdir) / 1e9:.3f} GB), save() held the loop "
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
# by resuming. Depth 2 (4 until phase 13 joined the script, 8 before):
# the checkpoints' writes and reads are most of the phase's time, and the
# script must stay within its limit. One epoch's
# checkpoint with its Adam moments is about 1 GB (4 GB at depth 8), so
# only the latest is kept (it is what 8f serves).
TRAIN_MOE_ARGS = TRAIN_ARGS + ["--moe_experts", "8", "--moe_every", "2",
                               "--moe_top_k", "2", "--num_kv_heads", "2",
                               "--max_checkpoints", "1"]
TRAIN_MOE_ARGS[TRAIN_MOE_ARGS.index("--epochs") + 1] = "1"
TRAIN_MOE_ARGS[TRAIN_MOE_ARGS.index("--model_depth") + 1] = "2"
# 8f: the served prompt's last-position logits (the serving forward, fp32)
# against train_forward's (fp32, B1 through its fp32 kernel) at a
# capacity factor of E/k, where no expert can overflow (capacity = the
# forward's tokens), so that no token is dropped: every prompt compares.
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
    at run_lm_bench's width, depth 2 (TRAIN_MOE_ARGS, bf16): epoch 0 (6 steps),
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
        f"plain block {routed}; save() held the loop "
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
    against train_forward's (fp32, each prompt alone, at capacity factor
    E/k: no token can drop, so every prompt compares; none compared fails)
    → B4p's launches."""
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
        # cf = E/k: each expert's capacity is every token of the forward.
        kw["capacity_factor"] = kw["num_experts"] / kw["top_k"]
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
        f"each prompt alone, capacity factor E/k): {len(gaps)}/{len(prompts)} "
        f"prompts without a dropped token compared, max |diff| over them "
        f"{gap:.3e} (limit {MOE_LOGITS_ATOL} both)")
    if max(dense_gaps) > MOE_LOGITS_ATOL or not gap <= MOE_LOGITS_ATOL:
        failed.append(f"served logits differ: {max(dense_gaps)}, {gap}")
    if len(gaps) != len(prompts):
        failed.append(f"train_forward dropped a token at capacity factor E/k "
                      f"in {len(prompts) - len(gaps)} of {len(prompts)} "
                      "prompts: the train-vs-serve comparison must cover "
                      "every prompt")
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
# 6a's synthetic split: a quarter of MNIST's 60,000 (234 steps an epoch;
# the whole set until phase 14 joined the script), the test split 2,500.
MAIN_6A = ["--synthetic_size", "15000"]
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
# The fast path's timing set at batch 64: 100 steps an epoch (SPAWN_SIZE
# until phase 14 joined the script).
TIME_FAST_SIZE = 6400
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
    for key in ("trace", "mu", "nu"):  # momentum; Adam's moments
        mine, saved = opt.get(key), blob["opt_state"].get(key)
        if (mine is None) != (saved is None):
            bad.append(f"optimizer {key} present on one side only")
        elif mine is not None:
            bad += [f"{key} buffer {i}" for i, (a, b) in enumerate(
                zip(mine, saved)) if not torch.equal(a, b)]
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
    trainer, out = _train(MAIN_6A + ["--epochs", "3", "--checkpoint_dir",
                                     ckdir])
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
    again, out = _train(MAIN_6A + ["--epochs", "3", "--checkpoint_dir",
                                     ckdir])
    bad = _cnn_state_errors(torch, again, mgr.read(2))
    log(f"[cnn] re-run at --epochs 3: epochs trained {len(again.history)}, "
        f"state vs epoch_2 differs in {bad or 'nothing'}")
    if "Resumed from checkpoint epoch 2" not in out or again.history or bad:
        failed.append("the restore is not epoch 2's state")
    del again
    resumed, out = _train(MAIN_6A + ["--epochs", "4", "--checkpoint_dir",
                                     ckdir])
    log(f"[cnn] --epochs 4: epochs trained "
        f"{[h['epoch'] for h in resumed.history]}")
    if ("Resumed from checkpoint epoch 2" not in out
            or [h["epoch"] for h in resumed.history] != [3]):
        failed.append("--epochs 4 did not resume at epoch 3 for one epoch")
    del resumed

    # One flipped byte in epoch 3's state file: discovery quarantines it and
    # resumes from epoch 2.
    _flip_byte(f"{ckdir}/epoch_3/state.pt")
    healed, out = _train(MAIN_6A + ["--epochs", "5", "--checkpoint_dir",
                                     ckdir])
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


def profile_cnn_epoch(torch, trainer, label, steps=None, out=None) -> float:
    """Busy share of one more epoch of ``trainer`` under torch.profiler
    (its first ``steps`` steps on the loader path, when given): summed
    CUDA kernel time over the wall time (the profiler's own host cost
    included). ``out`` (a dict) gets B1-B3's share of the device time and
    the device milliseconds a step."""
    import itertools

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
        with _kineto(torch) as prof:
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
    if out is not None:
        out.update(flash_share=flash / busy, device_ms=busy * 1e3 / steps)
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
    64 (6a's last epoch), the fast path at batch 64 (on TIME_FAST_SIZE
    images: its profiled epoch is the whole epoch), then both paths at
    global batch 16384 (fp32) and the fast path there in bf16, each after
    a warm-up epoch, with cuDNN's default (non-deterministic) choices.
    The step path's busy share is read over PROFILE_STEPS steps: with
    whole profiled epochs of 937 steps the script, phase 10 included,
    took over 1,000 s on an H100 80GB HBM3 host."""
    out = {}
    runs = [("step path, batch 64", readings["main_trainer"])]
    for label, batch, flags in (
            ("fast path, batch 64", 64,
             ["--fast_epoch", "--synthetic_size", str(TIME_FAST_SIZE)]),
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
        busy = profile_cnn_epoch(torch, trainer, label, PROFILE_STEPS)
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
    lap = _laps("cnn")
    with tempfile.TemporaryDirectory() as tmp:
        readings = check_cnn_main_path(torch, tmp)
        lap("6a main path")
        check_cnn_fast_path(torch, tmp)
        lap("fast path")
        check_cnn_step(torch)
        lap("step check")
        readings["uci_digits_accuracy"] = check_cnn_real_digits(repo)
        lap("uci_digits")
        check_cnn_two_ranks(torch, tmp)
        lap("two ranks")
        readings["timing"] = time_cnn(torch, readings, tmp, card)
        lap("timing")
    return readings


# ---- phase 7: the image families of BASELINE.json --------------------------

# BASELINE.json config 4, ViT-Tiny on CIFAR-100 (attention path, bf16):
# bench.py run_vit_bench's model, batch and optimizer (bench.py:380-416),
# the synthetic split cut to 6,400 images (25 steps an epoch; 12,800
# until phase 14 joined the script) so that the phase stays short.
VIT_ARGS = ["--model", "vit_tiny", "--dataset", "cifar100", "--synthetic_data",
            "--synthetic_size", "6400", "--batch_size", "256", "--epochs",
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
# the synthetic split cut to 3,200 images (25 steps an epoch; 6,400 until
# phase 14 joined the script, 12,800 until phase 13).
RESNET_ARGS = ["--model", "resnet18", "--dataset", "cifar10",
               "--synthetic_data", "--synthetic_size", "3200",
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


def _copy_model(trainer, remat=False):
    """A fresh copy of ``trainer``'s model (a ViT, or the long-context
    classifier) with its current weights, on its device."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.models.seq_transformer import LongContextTransformer

    src = trainer.state.model
    if trainer.config.model == "long_context":
        model = LongContextTransformer(src.spec._replace(remat=remat))
    else:
        model = get_model(trainer.config.model,
                          num_classes=src.head.out_features,
                          side=trainer.train_split.images.shape[1],
                          in_channels=3, depth=len(src.block_names),
                          remat=remat)
    model.load_state_dict(src.state_dict())
    for name in model.block_names:
        getattr(model, name).attn.attention_fn = \
            getattr(src, name).attn.attention_fn
    return model.to(trainer.device)


def _vit_step(torch, trainer, x, y, attention_fn, dtype, remat=False):
    """One SGD-momentum step in ``dtype`` of a copy of ``trainer``'s model
    (a ViT or the long-context classifier) on (x, y), every block's
    attention through ``attention_fn`` (None: the trainer's own, B1-B3),
    each block recomputed in the backward with ``remat`` → (loss,
    {parameter name: gradient})."""
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    model = _copy_model(trainer, remat)
    if attention_fn is not None:
        for name in model.block_names:
            getattr(model, name).attn.attention_fn = attention_fn
    state = TrainState(0, model, make_optimizer(model.parameters(), "sgd",
                                                lr=0.01, momentum=0.9))
    m = make_train_step(state, reduce=lambda t: t, compute_dtype=dtype)(x, y)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return float(m.loss), grads


def _kernel_attention(trainer):
    """The attention a trainer's model runs (B1-B3 on the card):
    flash_attention for a ViT, --seq_strategy's for long_context."""
    from ddp_tpu_torch.ops import flash as fl

    fn = trainer.state.model.block1.attn.attention_fn
    return fn or (lambda q, k, v: fl.flash_attention(q, k, v))


def _sdpa_attention(torch, causal=False):
    """PyTorch's FlashAttention-2 (scaled_dot_product_attention, flash
    backend) on [B, T, H, D]: P and dS rounded to bf16 as B1-B3 round
    them. The bf16 step checks' yardstick, never on the path."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fn(q, k, v):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal).transpose(1, 2)

    return fn


def _zero_keys_counted(torch, q, k, v):
    """The plain non-causal attention with the key rows of the last
    128-key tile past S filled with zeros and counted by the softmax: what
    a B1 that forgot the key mask of TMA's zero fill would give (at T 65,
    63 zero keys; at T 3137, 63)."""
    pad = (0, 0, 0, 0, 0, -k.shape[1] % 128)
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     torch.nn.functional.pad(k.float(), pad))
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p,
                     torch.nn.functional.pad(v.float(), pad))
    return o.to(q.dtype)


def _tail_rows(torch, fn, rows: list, keys=-1):
    """``fn`` (an attention function, ``(q, k, v)`` or an LM block's ``(q,
    k, v, causal)``) that records, for each call (each block, in the
    forward's order), the gradients of key rows ``keys`` (the last) of its
    k and v in the backward: ``rows`` gets {"k": [B, H, D], "v": ...} a
    call."""
    def wrapped(q, k, v, *rest):
        entry = {}
        rows.append(entry)
        for name, t in (("k", k), ("v", v)):
            t.register_hook(lambda g, name=name: entry.__setitem__(
                name, g[:, keys].float().clone()))
        return fn(q, k, v, *rest)

    return wrapped


def _tail_error(torch, got: list, want: list) -> float:
    """Relative norm error of the last key row's dK and dV over every
    block (_tail_rows' lists); 1.0 where a gradient is missing."""
    if len(got) != len(want) or any(len(e) != 2 for e in got + want):
        return 1.0
    pairs = [(a[n], b[n]) for a, b in zip(got, want) for n in ("k", "v")]
    diff = sum(float((a - b).norm()) ** 2 for a, b in pairs)
    norm = sum(float(b.norm()) ** 2 for _, b in pairs)
    return (diff / max(norm, 1e-60)) ** 0.5


# The bf16 step gate (ROADMAP C15): a bf16 step through B1-B3 may be at
# most BF16_GATE_RATIO times as far from the exact step (fp32 throughout,
# the plain attention) as the same bf16 step through PyTorch's
# FlashAttention-2 is, in the worst leaf's and in the whole gradient's
# relative error. Every flash kernel rounds P and dS to bf16 for its
# products, so the bf16 plain step (fp32 attention inside) is not the
# reference a bf16 flash step can meet: that old reading, STEP_TOL["bf16"]
# against the bf16 plain step, is still printed beside the gate. The
# loss against the bf16 plain step and the last key row (_tail_rows)
# keep their limits. On an NVIDIA H100 80GB HBM3 at 700 W, 10b's ratio
# read 0.84-1.21 over five seeds (kernel against SDPA, worst leaf).
BF16_GATE_RATIO = 1.5


def _bf16_gate(e_kernel, e_sdpa) -> dict:
    """The gate's ratios from _grad_errors of the kernel's and SDPA's bf16
    steps against the exact step."""
    leaf = e_kernel["leaf"][1] / max(e_sdpa["leaf"][1], 1e-30)
    grad = e_kernel["grad"] / max(e_sdpa["grad"], 1e-30)
    return dict(leaf=leaf, grad=grad,
                ok=leaf <= BF16_GATE_RATIO and grad <= BF16_GATE_RATIO)


def _gate_text(g) -> str:
    return (f"worst leaf {g['leaf']:.3f}x, gradient {g['grad']:.3f}x SDPA's "
            f"distance from the exact step (limit {BF16_GATE_RATIO}x)")


def _tokens_of(trainer) -> int:
    """The sequence length a trainer's model attends over."""
    if trainer.config.model == "long_context":
        return trainer.config.seq_len
    model = trainer.state.model
    side = trainer.train_split.images.shape[1] // model.patch_size
    return side * side + int(model.use_cls_token)


def check_vit_step(torch, trainer, *, batch=64, tag="vit", controls=None,
                   gate_controls=None, tail=False,
                   record=None) -> list[str]:
    """One step through B1-B3 against the same step through the plain
    attention (which must launch nothing), from the trained weights on the
    first ``batch`` training examples (a ViT's images or the long-context
    model's sequences).

    fp32: STEP_TOL["fp32"] against the exact step (fp32, plain attention).
    bf16: the gate of BF16_GATE_RATIO against the exact step, measured by
    the same bf16 step through SDPA; the loss within VIT_BF16_LOSS_TOL of
    the bf16 plain step; the old reading (STEP_TOL["bf16"] against the
    bf16 plain step) printed. With ``tail`` the last key row's dK and dV in
    every block are held to the attention limit too (_tail_rows): at a
    long T one row moves the parameters' gradients by too little for the
    leaf limits to see a dropped one. Negative controls must fail the same
    checks in both dtypes: ``controls`` (None: a B1 that counts the last
    tile's zero-filled keys, where S is not a multiple of 128) and always
    a B3 that drops the last key row. ``gate_controls`` must fail the bf16
    gate itself, whatever the loss and tail-row checks say (and STEP_TOL
    in fp32): they show that the gate can see an attention fault at this
    shape. ``record`` (a dict) gets the readings and verdicts."""
    from ddp_tpu_torch.ops import flash as fl

    images, labels = trainer.train_split
    x = torch.from_numpy(np.array(images[:batch])).to(trainer.device)
    y = torch.from_numpy(labels[:batch]).to(trainer.device)
    drop = _drop_key_grad(torch, slice(-1, None))

    def plain(q, k, v):
        return fl.attention_with_lse_reference(q, k, v, False)[0]

    tokens = _tokens_of(trainer)
    last = tokens - 1
    if controls is None:
        controls = {}
        if tokens % 128:
            controls[f"zero-filled keys {tokens}-{tokens - 1 + -tokens % 128}"
                     " counted by the softmax"] = \
                lambda q, k, v: _zero_keys_counted(torch, q, k, v)
    controls = dict(controls)
    controls[f"dK/dV of key row {last} dropped"] = \
        lambda q, k, v: plain(q, drop(k), drop(v))
    gate_controls = dict(gate_controls or {})
    record = {} if record is None else record
    base = _kernel_attention(trainer)
    failed, exact_cache = [], {}

    def step(fn, dtype, routes, flips, rows=None):
        with fixed_routing(torch, routes, flips):
            return _vit_step(torch, trainer, x, y,
                             _tail_rows(torch, fn, rows) if tail else fn,
                             dtype)

    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        routes, flips = [], []
        rows = {"kernel": [], "plain": [], "exact": []}
        kernel = step(base, dtype, routes, flips, rows["kernel"])
        _zero(fl.flash_attention.launches)
        # The exact step, under the kernel step's routing; a dense model's
        # is the same in both dtypes.
        if routes or "exact" not in exact_cache:
            exact_cache["exact"] = step(plain, torch.float32, routes,
                                        flips if dname == "fp32" else [],
                                        rows["exact"])
            exact_cache["rows"] = rows["exact"]
        exact, exact_rows = exact_cache["exact"], exact_cache["rows"]
        if dname == "fp32":
            want, want_rows = exact, exact_rows
        else:
            want = step(plain, dtype, routes, flips, rows["plain"])
            want_rows = rows["plain"]
            sdpa = step(_sdpa_attention(torch), dtype, routes, [], [])
            e_sdpa = _grad_errors(sdpa, exact)
            del sdpa
        limits = STEP_TOL[dname]
        loss_tol = VIT_BF16_LOSS_TOL if dname == "bf16" else limits["loss"]

        def judge(got, got_rows, label, gate_only=False):
            """(within every limit, the reading) of one step; with
            ``gate_only``, the bf16 gate alone decides."""
            e = _grad_errors(got, want)
            tail_err = (_tail_error(torch, got_rows, want_rows)
                        if tail else 0.0)
            text = f"{_errors_text(e)}"
            if dname == "fp32":
                ok = _within(e, limits)
                text += f" (limits {limits})"
            else:
                g = _bf16_gate(_grad_errors(got, exact), e_sdpa)
                ok = g["ok"] and (gate_only or e["loss"] <= loss_tol)
                text += (f" (old reading; STEP_TOL bf16 {limits} "
                         f"{'holds' if _within(e, dict(limits, loss=loss_tol)) else 'is exceeded'}); "
                         f"gate: {_gate_text(g)}, loss rel {e['loss']:.2e} "
                         f"(limit {loss_tol})")
                record.setdefault(dname, {})[label] = dict(
                    leaf_ratio=g["leaf"], grad_ratio=g["grad"],
                    old_leaf=e["leaf"][1], loss=e["loss"])
            if tail:
                text += (f"; key row {last}'s dK/dV in every block rel "
                         f"{tail_err:.2e} (limit {limits['attn']})")
                ok = ok and (gate_only and dname == "bf16"
                             or tail_err <= limits["attn"])
            return ok, text

        ok, text = judge(kernel, rows["kernel"], "kernel")
        log(f"[{tag}] one {dname} step, kernel vs plain attention (batch "
            f"{batch}): loss {kernel[0]:.6f} vs {want[0]:.6f}; {text}"
            + (f"; SDPA bf16 vs exact: {_errors_text(e_sdpa)}"
               if dname == "bf16" else "")
            + (f"; routing held to the kernel step's, own choices would "
               f"differ at {flips} (token, k) per routed block"
               if routes else ""))
        record.setdefault("verdict", {})[dname] = ok
        if not ok:
            failed.append(f"the {dname} kernel step disagrees with the "
                          "plain one")
        del kernel
        for label, attention_fn in {**controls, **gate_controls}.items():
            got_rows = []
            got = step(attention_fn, dtype, routes, [], got_rows)
            ok, text = judge(got, got_rows, label,
                             gate_only=label in gate_controls)
            del got
            alone = (" (the gate alone)"
                     if label in gate_controls and dname == "bf16" else "")
            log(f"[{tag}] {dname} control{alone}, {label}: {text}")
            record.setdefault("controls", {})[f"{dname} {label}"] = not ok
            if ok:
                failed.append(f"the {dname} check passes a control: {label}")
        if any(fl.flash_attention.launches.values()):
            failed.append(f"the plain path launched "
                          f"{fl.flash_attention.launches}")
        del want
        torch.cuda.empty_cache()
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
    readings["launches_fp32"] = {n: got[f"{n}_fp32"] for n in FLASH_NAMES}
    if failed:
        raise AssertionError(f"phase 7a: {failed}")
    return readings


# Phase 7c: vit_moe_tiny (8 experts, top-2, every 2nd of 12 blocks
# routed; 64 tokens, no cls) on the same split and recipe as 7a.
# At depth 4 of its 12 (blocks 2 and 4 routed): a cut for the script's
# time since phase 13 joined it.
VIT_MOE_ARGS = (VIT_ARGS[:1] + ["vit_moe_tiny"] + VIT_ARGS[2:]
                + ["--model_depth", "4"])


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


def _resnet_step(torch, state_np, x, y, device, dtype=None, relu=None,
                 arch=("resnet18", 10)):
    """One step of the recipe (SGD 0.1, momentum 0.9, wd 1e-4, fp32, or
    fp64 with ``dtype=torch.float64``) of ResNet-18 from ``state_np`` on
    (x, y) on ``device``, its ReLUs through ``relu`` (a _TiedRelu) if
    given → (loss, and as CPU tensors the gradients, the updated
    parameters and the BatchNorm buffers after the step)."""
    from ddp_tpu_torch.models import get_model, resnet
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    dtype = dtype or torch.float32
    model = get_model(arch[0], num_classes=arch[1], side=x.shape[1],
                      in_channels=3)
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


def check_resnet_step(torch, trainer, *, batch=32, tag="resnet",
                      gated=("seeded", "trained"),
                      control="seeded", against="cpu",
                      sets=("seeded", "trained")) -> list[str]:
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
    from which each fp32 step's distance is printed. ``gated``: the
    weight sets held to the limits (the others are readings);
    ``control``: the one the control runs on. ``against="fp64"`` holds
    the card's step, and the control, to that fp64 step instead of the
    CPU's fp32 one (ROADMAP C14: at a small batch the CPU's own fp32 step
    can sit 4e-4 from fp64, where the card's sits 6e-6). ``sets``: the
    weight sets stepped."""
    import torch.nn.functional as F

    images, labels = trainer.train_split
    x, y = np.array(images[:batch]), labels[:batch]
    arch = (trainer.config.model, trainer.num_classes)
    seeded = _live_bn_scales(trainer.state.model.init_state(
        trainer.config.seed))
    trained = {k: v.detach().cpu().numpy()
               for k, v in trainer.state.model.state_dict().items()}
    failed = []
    for label, state_np in (("seeded", seeded), ("trained", trained)):
        if label not in sets:
            continue
        card = _TiedRelu(F)
        got = _resnet_step(torch, state_np, x, y, trainer.device, relu=card,
                           arch=arch)
        tied = _TiedRelu(F, card.masks)
        want = _resnet_step(torch, state_np, x, y, "cpu", relu=tied,
                            arch=arch)
        own = _resnet_step(torch, state_np, x, y, "cpu", arch=arch)
        exact = _resnet_step(torch, state_np, x, y, "cpu", torch.float64,
                             relu=_TiedRelu(F, card.masks), arch=arch)
        ref = exact if against == "fp64" else want
        ref_name = ("the CPU's fp64" if against == "fp64"
                    else "the CPU's fp32")
        e, bufs = _resnet_errors(got, ref)
        log(f"[{tag}] one step from the {label} weights, card (fp32, TF32 "
            f"off) vs {ref_name} step (batch {batch}, ReLU masks tied): loss "
            f"{got[0]:.6f} vs {ref[0]:.6f}; {_resnet_text(e, bufs)} (limits "
            f"{CNN_STEP_TOL})")
        log(f"[{tag}] reading, {label}: {tied.flips} of "
            f"{sum(m.numel() for m in card.masks)} ReLU inputs on the other "
            f"side of 0 on the CPU; the CPU's step with its own masks vs the "
            f"card's: {_resnet_text(*_resnet_errors(got, own))}")
        for side, step in (("card", got), ("CPU", want)):
            log(f"[{tag}] witness, {label}: the {side}'s fp32 step vs the "
                f"CPU's fp64 (masks tied): "
                f"{_resnet_text(*_resnet_errors(step, exact))}")
        if label in gated and not (_cnn_within(e)
                                   and bufs[1] <= CNN_STEP_TOL["leaf"]):
            failed.append(f"the card's step from the {label} weights "
                          "disagrees with the CPU's")
        if label == control:
            blind = (got[0], {n: g * 0 if ".Conv_" in n else g
                              for n, g in got[1].items()}, got[2], got[3])
            e, bufs = _resnet_errors(blind, ref)
            log(f"[{tag}] control, the card's step with the blocks' conv "
                f"gradients zeroed, vs {ref_name} step: "
                f"{_resnet_text(e, bufs)}")
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

    lap = _laps("images")
    with tempfile.TemporaryDirectory() as tmp:
        vit = check_vit(torch, card, tmp)
        torch.cuda.empty_cache()
        lap("7a")
        resnet = check_resnet(torch, card, tmp)
        torch.cuda.empty_cache()
        lap("7b")
        vit_moe = check_vit_moe(torch, card, tmp)
        lap("7c")
    return {"vit": vit, "resnet": resnet, "vit_moe": vit_moe}


# ---- phase 9: the trainer's fault tolerance --------------------------------

# Appended to every phase-9 command (["--device", "cpu"] when rehearsing).
FT_DEVICE_ARGS: list[str] = []
# 9a: run_lm_bench's width (phase 5's TRAIN_ARGS: 2 epochs of 6 steps,
# bf16) at depth 2 (4 until phase 13 joined the script, 8 before: its
# checkpoints' writes are most of the phase's time); the SIGTERM lands
# before global step 8, epoch 1's batch 2.
FT_LM_ARGS = list(TRAIN_ARGS)
FT_LM_ARGS[FT_LM_ARGS.index("--model_depth") + 1] = "2"
FT_SIGTERM_STEP = 8
# 9b: the reference's path (train.py --epochs 3 --batch_size 64, SGD
# 0.01) on synthetic MNIST cut from 60,000 to 3,200 images (50 steps an
# epoch; 6,400 until phase 14 joined the script, 12,800 until phase 13),
# every run under the
# supervisor (one worker process, as the drills run), cuDNN deterministic
# (without it two uninterrupted runs part by ~6e-8: a conv backward's
# order); the kill lands in epoch 1, the stall in epoch 1.
FT_CNN_ARGS = ["--model", "simple_cnn", "--synthetic_data",
               "--synthetic_size", "3200", "--epochs", "3", "--batch_size",
               "64", "--log_interval", "300", "--deterministic"]
FT_KILL_STEP = 75
FT_STALL = "stall:input@step62:30s"
# 9c: two gloo ranks on the one card at 32 each (global 64), 3 epochs of
# 50 steps; rank 1 is lost in epoch 1, a host comes back at epoch 2.
FT_ELASTIC_CHAOS = "shrink:rank1@step75,grow:+1@epoch2"
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


def manifest_order_failures(state, root, *, writer_skips_wait=False) -> list:
    """Save epoch 0 of ``state`` into ``root`` (asynchronously) with the
    writer held just before its commit, the rename of the temporary
    directory, and read the directory there: neither ``epoch_0`` nor its
    manifest may show yet; after ``wait()`` both must. → failures.
    ``writer_skips_wait`` is the control: a writer that manifests the
    epoch from its temporary directory without waiting for the commit
    (the read before the commit must catch it)."""
    import os

    from ddp_tpu_torch.train import checkpoint as ck

    held, go = threading.Event(), threading.Event()
    real = ck.CheckpointManager._commit

    def commit(self, tmp, final):
        if writer_skips_wait:
            with open(os.path.join(os.path.dirname(final),
                                   "epoch_0" + ck.MANIFEST_SUFFIX), "w") as f:
                json.dump(ck.build_manifest(tmp), f)
        held.set()
        go.wait(600)
        real(self, tmp, final)

    names = ["epoch_0", "epoch_0" + ck.MANIFEST_SUFFIX]
    mgr = ck.CheckpointManager(root)
    with _patched((ck.CheckpointManager, "_commit", commit)):
        mgr.save(0, state)
        held.wait(600)
        before = sorted(n for n in os.listdir(root) if n in names)
        go.set()
        mgr.wait()
    after = sorted(n for n in os.listdir(root) if n in names)
    failed = []
    if before:
        failed.append(f"before the commit the directory shows {before}")
    if after != names or mgr.verify_epoch(0) != []:
        failed.append(f"after wait() the directory shows {after}")
    return failed


def steady_sync_error(torch, step, batches) -> str | None:
    """``step`` over ``batches`` under ``torch.cuda.set_sync_debug_mode(
    "error")`` → None when no call synchronized, else the error the mode
    raised at the first that did."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in batches:
            step(*args)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


def _lm_sync_failures(torch, trainer, seen) -> list:
    """C10: FT_SYNC_STEPS steady LM steps of ``trainer`` with the
    watchdog, a chaos engine (an event past the run) and the SIGTERM
    handler armed, and with none: no synchronizing call in either
    (sync debug mode "warn" plus wrappers count 0), and none under the
    mode "error". Control: the same steps with one ``.item()`` each must
    fail the "error" check."""
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
    error = steady_sync_error(torch, trainer.runner.step, batches)

    def with_item(*args):
        m = trainer.runner.step(*args)
        m.loss.item()  # the control: one host read a step
        return m

    control = steady_sync_error(torch, with_item, batches)
    log(f"[ft] 9a {FT_SYNC_STEPS} steady LM steps, synchronizing calls: "
        f"off {counts['off']}, watchdog + chaos + preempt check armed "
        f"{counts['armed']}; under the sync debug mode \"error\": "
        f"{error or 'none raised'}; control, one .item() a step: "
        f"{control or 'none raised'}")
    failed = []
    if counts["off"]["total"] or counts["armed"]["total"]:
        failed.append(f"synchronizing calls in the steady LM step: {counts}")
    if error is not None:
        failed.append(f"the steady LM step synchronizes: {error}")
    if control is None:
        failed.append("the sync check passes a step with an .item()")
    return failed


ASYNC_STEPS = 8  # steady LM steps timed without a save, and right after one


def _timed_steps(torch, step, batches) -> list[float]:
    """ms of each step of ``step`` over ``batches`` (CUDA events)."""
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(batches) + 1)]
    marks[0].record()
    for args, mark in zip(batches, marks[1:]):
        step(*args)
        mark.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def state_digest(torch, params: dict, opt: dict, step: int) -> str:
    """sha256 of a training state: the step, the parameters by name and
    the optimizer's count and buffers, each tensor's bytes on the host."""
    import hashlib

    h = hashlib.sha256(f"{step} {opt['count']}".encode())
    tensors = [params[k] for k in sorted(params)]
    tensors += [b for k in ("trace", "mu", "nu", "ema")
                for b in opt.get(k) or []]
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(t.view(torch.uint8).numpy().tobytes()
                 if t.element_size() == 1 else
                 t.view({2: torch.int16, 4: torch.int32,
                         8: torch.int64}[t.element_size()]).numpy().tobytes())
    return h.hexdigest()


def _exit_after_save(torch, tmp) -> list:
    """A process that builds the LM (TRAIN_ARGS' width at depth 2), takes
    two steps, saves asynchronously with ``mid_batch`` 2 (a preemption
    save) and returns from its main at once, the writer in flight: the
    epoch it leaves verifies and restores the state's digest bit for
    bit."""
    import os

    root = os.path.join(tmp, "exit_after_save")
    args = TRAIN_ARGS + FT_DEVICE_ARGS + ["--checkpoint_dir", root]
    args[args.index("--synthetic_size") + 1] = "16"
    args[args.index("--model_depth") + 1] = "2"
    code = (
        "import json, torch, chip_smoke\n"
        "from ddp_tpu_torch.train import trainer as tr\n"
        "from ddp_tpu_torch.train.config import TrainConfig\n"
        "from ddp_tpu_torch.train.checkpoint import CheckpointManager\n"
        f"t = tr.LMTrainer(TrainConfig.from_args({args!r}))\n"
        "G = t.global_batch_size\n"
        "for i in range(2):\n"
        "    t.runner.step(t.tokens[i * G:(i + 1) * G])\n"
        "t.state.step = t.optimizer.count\n"
        "digest = chip_smoke.state_digest(torch, t.model.state_dict(), "
        "t.optimizer.state_dict(), t.state.step)\n"
        f"mgr = CheckpointManager({root!r})\n"
        "mgr.save(0, t.state, steps_per_epoch=t.steps_per_epoch, "
        "mid_batch=2)\n"
        "print(json.dumps({'digest': digest, 'in_flight': mgr.in_flight}), "
        "flush=True)\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if res.returncode:
        return [f"the exit-after-save process failed: {res.stderr[-1500:]}"]
    said = json.loads(res.stdout.strip().splitlines()[-1])
    from ddp_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(root)
    blob = mgr.read(0)
    got = state_digest(torch, blob["params"], blob["opt_state"], blob["step"])
    problems = mgr.verify_epoch(0)
    log(f"[ft] 9a a process that returned right after save() (in flight: "
        f"epoch {said['in_flight']}; {wall:.1f} s with the CUDA start): "
        f"epoch 0 manifest problems {problems}, mid_batch "
        f"{blob.get('mid_batch')}, restored digest "
        + ("equal to the saved state's" if got == said["digest"] else
           "DIFFERS from the saved state's"))
    if said["in_flight"] != 0 or problems != [] or got != said["digest"] \
            or blob.get("mid_batch") != 2:
        return ["the save of a process that exited right after save() is "
                "not durable and exact"]
    return []


def check_async_save(torch, trainer, tmp) -> tuple[dict, list]:
    """Phase 9a's asynchronous save at run_lm_bench's width, depth 4: steady step
    times (CUDA events) without a save and right after one, the time
    save() holds the loop against the blocking save's (async_save=False),
    the time wait() then blocks, the saved epoch restored bit for bit,
    the peak memory allocated over a save and the steps after it against
    the steps' own (a save makes no second copy of the state on the
    card: it adds less than a tenth of the state's bytes); the
    manifest-order check with its control (a writer that skips the
    commit wait, caught by a read before the commit); and a process that
    exits right after save() (_exit_after_save) → (readings, failures)."""
    import os

    from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
    from ddp_tpu_torch.parallel.ddp import TrainState
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.optim import make_optimizer

    G = trainer.global_batch_size
    batches = [(trainer.tokens[(i * G) % len(trainer.tokens):][:G],)
               for i in range(ASYNC_STEPS)]
    step = trainer.runner.step
    _timed_steps(torch, step, batches[:2])  # warm
    trainer.state.step = trainer.optimizer.count
    torch.cuda.reset_peak_memory_stats()
    quiet = _timed_steps(torch, step, batches)
    quiet_peak = torch.cuda.max_memory_allocated()
    want = state_digest(torch, trainer.model.state_dict(),
                        trainer.optimizer.state_dict(), trainer.state.step)
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(trainer.model.state_dict().values())
                 + [b for k in ("trace", "mu", "nu", "ema")
                    for b in getattr(trainer.optimizer, k, None) or []])
    holds, waits, around, peaks, card_holds = [], [], [], [], []
    for turn in range(2):  # the first save allocates its pinned buffers
        mgr = CheckpointManager(os.path.join(tmp, f"async{turn}"))
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        t0 = time.perf_counter()
        mgr.save(0, trainer.state, steps_per_epoch=trainer.steps_per_epoch)
        holds.append(time.perf_counter() - t0)
        around.append(_timed_steps(torch, step, batches))
        end.record()
        end.synchronize()
        # The card's time from save() to the last step's end, less the
        # steps': what the copy held the training stream.
        card_holds.append(start.elapsed_time(end) - sum(around[-1]))
        t0 = time.perf_counter()
        mgr.wait()
        waits.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        if turn == 0:
            blob = mgr.read(0)
            got = state_digest(torch, blob["params"], blob["opt_state"],
                               blob["step"])
            del blob
        trainer.state.step = trainer.optimizer.count
    blocking = CheckpointManager(os.path.join(tmp, "blocking"),
                                 async_save=False)
    t0 = time.perf_counter()
    blocking.save(0, trainer.state, steps_per_epoch=trainer.steps_per_epoch)
    blocking_s = time.perf_counter() - t0
    readings = {
        "step_p50_ms_no_save": float(np.median(quiet)),
        "step_p50_ms_after_save": [float(np.median(a)) for a in around],
        "card_hold_ms": card_holds,
        "save_hold_s": holds, "wait_s": waits, "blocking_save_s": blocking_s,
        "peak_mb_no_save": quiet_peak / 2**20,
        "peak_mb_with_save": [p / 2**20 for p in peaks]}
    log(f"[ft] 9a asynchronous save of the LM state ({nbytes / 1e9:.2f} GB "
        f"with Adam's moments): "
        f"save() held the loop {', '.join(f'{h:.3f}' for h in holds)} s "
        f"(first, then with the pinned buffers cached), the blocking save "
        f"{blocking_s:.3f} s; wait() after {ASYNC_STEPS} more steps "
        f"blocked {', '.join(f'{w:.3f}' for w in waits)} s; step p50 "
        f"{readings['step_p50_ms_no_save']:.2f} ms without a save, "
        + ", ".join(f"{a:.2f}" for a in readings["step_p50_ms_after_save"])
        + f" ms in the {ASYNC_STEPS} steps right after save(); the copy "
        "to the host held the training stream on the card "
        + ", ".join(f"{h:.2f}" for h in card_holds)
        + f" ms (from save() to the first step's start); peak "
        f"memory allocated {quiet_peak / 2**20:.0f} MiB over the steps "
        f"without a save, "
        + ", ".join(f"{p / 2**20:.0f}" for p in peaks)
        + " MiB over a save and the steps after it; the first "
        "save's epoch restores the state at save() "
        + ("bit for bit" if got == want else "WITH A DIFFERENCE"))
    failed = [] if got == want else [
        "the asynchronous save does not restore the state at save()"]
    # No second copy of the state on the card: a save adds less than a
    # tenth of the state's bytes to the steps' peak.
    if max(peaks) - quiet_peak >= nbytes / 10:
        failed.append(f"a save raised the peak memory by "
                      f"{(max(peaks) - quiet_peak) / 2**20:.0f} MiB")
    model = SimpleCNN.from_state(init_cnn_state(), trainer.device)
    small = TrainState(0, model, make_optimizer(model.parameters(), "sgd"))
    order = manifest_order_failures(small, os.path.join(tmp, "order"))
    control = manifest_order_failures(small, os.path.join(tmp, "skips"),
                                      writer_skips_wait=True)
    log(f"[ft] 9a manifest order, the directory read with the writer held "
        f"before its commit: {order or 'no epoch, no manifest'}; control, "
        f"a writer that skips the commit wait: {control or 'NOT caught'}")
    failed += order
    if not control:
        failed.append("a writer that manifests before the commit passed")
    failed += _exit_after_save(torch, tmp)
    return readings, failed


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
        return FT_LM_ARGS + FT_DEVICE_ARGS + [
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
    log(f"[ft] 9a two uninterrupted runs ({' '.join(FT_LM_ARGS)}): "
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
    readings["async_save"], bad = check_async_save(torch, resumed, tmp)
    failed += bad
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


def _run_all(commands: dict, tmp, timeout: float = 600) -> dict:
    """The commands (name → argv) at once, each in its own process, all
    awaited for at most ``timeout`` s (and killed on the way out) → name
    → (exit code, the lines of its output)."""
    return _await_all({name: _launch(argv, f"{tmp}/{name}.log")
                       for name, argv in commands.items()}, tmp, timeout)


def _launch_staggered(commands: dict, tmp, procs: dict,
                      delay: float) -> threading.Thread:
    """Launch every other command (name → argv) into ``procs`` now and the
    rest ``delay`` s later, from a thread (returned: join it before the
    wait): the halves' training, when a process holds the most of the
    card's memory, then falls apart."""
    names = list(commands)

    def launch(part):
        procs.update({name: _launch(commands[name], f"{tmp}/{name}.log")
                      for name in part})

    launch(names[0::2])

    def rest():
        time.sleep(delay)
        launch(names[1::2])

    thread = threading.Thread(target=rest, name="wave's second half")
    thread.start()
    return thread


def _await_all(procs: dict, tmp, timeout: float = 600) -> dict:
    """:func:`_run_all`'s wait on processes already started (name →
    ``_launch``'s process, its log ``{tmp}/{name}.log``)."""
    try:
        codes = {name: p.wait(timeout=timeout) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (codes[name], open(f"{tmp}/{name}.log").read().splitlines())
            for name in procs}


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


# ---- phase 10: the ImageNet family at 224² (the synthetic set) -----------

# The synthetic 224² set (data/imagenet.synthetic, JAX's bytes), written
# once as the preprocessed arrays --dataset imagenet reads memory-mapped
# (--data_root): 1,024 train images (154 MB of uint8; 2,048 until phase 14
# joined the script), the test split a
# quarter of it, as the registry sizes a synthetic one. 10d-10e's short
# runs read a 64-image split.
IMAGENET_TRAIN = 1024
IMAGENET_SMALL = 64
# 10a: ResNet-50 with the ImageNet stem, He et al. 2016's recipe (SGD
# momentum 0.9, weight decay 1e-4, lr 0.1 x batch / 256), batch 64 (a
# 9.6 MB batch: the native pool's gate opens at 7 images), the loader
# path with --num_workers 2, two epochs of 16 steps (32 until phase 14
# joined the script).
# The batches of 10a's card-vs-fp64 step gate, from the trained weights
# (the seeded weights' reading was left out when phase 14 joined the
# script; --step-spread reads both weight sets).
RESNET50_GATE_BATCHES = (2, 4)
RESNET50_ARGS = ["--model", "resnet50", "--dataset", "imagenet",
                 "--batch_size", "64", "--epochs", "2", "--lr", "0.025",
                 "--momentum", "0.9", "--weight_decay", "1e-4", "--augment",
                 "crop_flip", "--num_workers", "2", "--log_interval", "1000"]
# 10b: ViT-Tiny at 224², patch 4 as JAX's ViTTiny keeps it: 56² + 1 = 3137
# tokens (the last 128-key tile holds 65), bf16, batch 32, phase 7a's
# recipe, two epochs of 64 steps.
VIT224_ARGS = ["--model", "vit_tiny", "--dataset", "imagenet",
               "--batch_size", "32", "--epochs", "2", "--optimizer", "sgd",
               "--lr", "0.01", "--momentum", "0.9", "--compute_dtype",
               "bfloat16", "--augment", "crop_flip", "--num_workers", "2",
               "--log_interval", "1000"]
VIT224_SHAPE = ("ViT 224² non-causal T=S=3137", 32, 3137, 3137, 3, 64, False)
# Train flops an image at 224²: 6 x the 5.5 M parameters x 3137 tokens,
# plus the attention's 2 products of 2 x T² x 192 per block, x 3.
VIT224_TRAIN_FLOPS = int(6 * 5.53e6 * 3137 + 3 * 12 * 2 * 2 * 3137**2 * 192)
RESNET50_TRAIN_FLOPS = int(3 * 2 * 4.1e9)  # 4.1 G multiply-adds an image


def write_imagenet(root: str, n: int) -> float:
    """The synthetic set's train (n, seed 0) and test (n // 4, seed 1)
    splits as imagenet_{split}_{images,labels}.npy under ``root`` →
    seconds."""
    import os

    from ddp_tpu_torch.data import imagenet

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    for split, count, seed in (("train", n, 0), ("test", n // 4, 1)):
        data = imagenet.synthetic(count, seed=seed)
        np.save(os.path.join(root, f"imagenet_{split}_images.npy"),
                data.images)
        np.save(os.path.join(root, f"imagenet_{split}_labels.npy"),
                data.labels)
    return time.perf_counter() - t0


def _launches_apart(torch, args, base, cls="ImageTrainer"):
    """_train with B1-B3's launches of training and of evaluation apart
    (``cls``: the trainer class whose evaluate_raw is counted; SeqTrainer
    inherits ImageTrainer's) → (trainer, the printed lines, training
    launches, eval launches)."""
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.train import trainer as tr

    launches = fl.flash_attention.launches
    evals = dict.fromkeys(launches, 0)
    owner = getattr(tr, cls)
    real = owner.evaluate_raw

    def evaluate_raw(self):
        before = dict(launches)
        out = real(self)
        for k in launches:
            evals[k] += launches[k] - before[k]
        return out

    _zero(launches)
    fl.flash_attention.plain_routed = 0
    with _patched((owner, "evaluate_raw", evaluate_raw)):
        trainer, text = _train(args, base)
    torch.cuda.synchronize()
    return trainer, text, {k: launches[k] - evals[k] for k in launches}, evals


def _pool_equals_python(torch, trainer) -> list:
    """The native pool's batches against the Python gather's, on the card,
    bit for bit, over one epoch and a resumed (skip_batches) one."""
    from ddp_tpu_torch.data.loader import ShardedLoader

    images, labels = trainer.train_split
    kw = dict(device=trainer.device, seed=trainer.config.seed)
    pool = ShardedLoader(images, labels, trainer.global_batch_size,
                         num_workers=2, **kw)
    py = ShardedLoader(images, labels, trainer.global_batch_size,
                       num_workers=0, **kw)
    n, bad = 0, []
    try:
        if not pool.pool_engaged:
            return ["the native pool did not engage for 224² batches"]
        for epoch, skip in ((0, 0), (1, 3)):
            for a, b in zip(pool.epoch(epoch, skip), py.epoch(epoch, skip),
                            strict=True):
                n += 1
                if not (torch.equal(a.images, b.images)
                        and torch.equal(a.labels, b.labels)):
                    bad.append(f"epoch {epoch} batch {n}")
    finally:
        pool.close()
    log(f"[imagenet] 10a the native pool's {pool.pool_batches} batches vs "
        f"the Python gather's, on the card: "
        + (f"{n} bit for bit" if not bad else f"differ at {bad[:4]}"))
    if pool.pool_batches != n:
        bad.append(f"pool counted {pool.pool_batches} of {n} batches")
    return bad


def check_resnet50(torch, card, data, tmp) -> tuple[dict, list, object]:
    """10a: ResNet-50 / ImageNet-shaped 224² in bf16 and fp32 through
    main() on the loader path with --num_workers 2: the pool's batch
    counter = the steps, losses finite and falling, the bf16 run's
    resume exact, the pool's batches = the Python gather's, one step on
    the card (fp32) vs the CPU's fp64 step (RESNET50_GATE_BATCHES, ReLU masks
    tied, CNN_STEP_TOL) from the trained weights (from the seeded ones a
    reading) → (readings, failures, the fp32 trainer)."""
    readings, failed = {}, []
    trainer = None
    for dname in ("bfloat16", "float32"):
        ckdir = f"{tmp}/rn50_{dname}"
        args = ["--data_root", data, "--checkpoint_dir", ckdir,
                "--compute_dtype", dname]
        trainer, _ = _train(args, RESNET50_ARGS)
        steps = trainer.steps_per_epoch * trainer.config.epochs
        pool = trainer.loader.pool_batches
        log(f"[imagenet] 10a resnet50 {dname}: {steps} steps, the native "
            f"pool produced {pool} batches")
        for h in trainer.history:
            log(_epoch_line(h, f"resnet50 imagenet-224 {dname},")
                .replace("[cnn]", "[imagenet]"))
        if pool != steps:
            failed.append(f"resnet50 {dname}: the pool produced {pool} of "
                          f"{steps} batches")
        failed += [f"resnet50 {dname}: {f}" for f in _losses_fall(trainer)]
        label = f"resnet50 imagenet-224 {dname}, batch 64"
        readings[dname] = _image_readings(torch, trainer, label, card,
                                          RESNET50_TRAIN_FLOPS)
        if dname == "bfloat16":
            failed += _resume_failures(torch, args, RESNET50_ARGS, ckdir)
            failed += _pool_equals_python(torch, trainer)
        else:
            # Gated from the trained weights at batches 2 and 4, against
            # the CPU's fp64 step (masks tied; ROADMAP C14): a whole run
            # read the trained step's stem_bn.bias gradient 4.19e-04 off
            # the CPU's fp32 step at batch 2, and the fp64 witness put
            # that error on the CPU's fp32 (the card's step 6.06e-06 off
            # fp64; an H100 80GB HBM3 at 700 W). From the seeded weights
            # with live BatchNorm scales, fp32's own error on ResNet-50
            # is 1.0e-4 to 3.3e-4 of the gradient at batches 2-16: that
            # set is printed, not held.
            for batch in RESNET50_GATE_BATCHES:
                failed += check_resnet_step(
                    torch, trainer, batch=batch, tag=f"imagenet batch {batch}",
                    gated=("trained",), control="trained", against="fp64",
                    sets=("trained",))
        torch.cuda.empty_cache()
    return readings, failed, trainer


def check_vit224(torch, card, data, tmp) -> tuple[dict, list]:
    """10b: ViT-Tiny at 224² (T 3137) in bf16 through main(): B1 = B2 =
    B3 = depth x steps in training (evaluation's B1 apart), nothing
    routed to the plain block, no fp32 launch, losses falling, resume
    exact, one step through the kernels against the plain attention
    (batch 8, bf16 and fp32; check_vit_step's gates), key row 3136's
    dK/dV held too, and a B1 that counts the last tile's zero-filled keys
    and a B3 that drops that row (the ragged tile's last) must fail it →
    (readings,
    failures, the trainer)."""
    from ddp_tpu_torch.ops import flash as fl

    ckdir = f"{tmp}/vit224"
    args = ["--data_root", data, "--checkpoint_dir", ckdir]
    trainer, _, train, evals = _launches_apart(torch, args, VIT224_ARGS)
    routed = fl.flash_attention.plain_routed
    depth = len(trainer.state.model.block_names)
    steps = trainer.steps_per_epoch * trainer.config.epochs
    log(f"[imagenet] 10b vit_tiny at 224² (T 3137), depth {depth}, {steps} "
        f"steps: training launches {train} (depth x steps = "
        f"{depth * steps}), evaluation {evals}, routed {routed}, the pool "
        f"produced {trainer.loader.pool_batches} batches")
    for h in trainer.history:
        log(_epoch_line(h, "vit_tiny imagenet-224 bf16,")
            .replace("[cnn]", "[imagenet]"))
    failed = [f"{n} bf16: {train[f'{n}_bf16']} training launches, not "
              f"{depth * steps}" for n in FLASH_NAMES
              if train[f"{n}_bf16"] != depth * steps]
    if routed or any(train[f"{n}_fp32"] for n in FLASH_NAMES):
        failed.append(f"routed {routed}, launches {train}")
    if evals["flash_attn_fwd_bf16"] == 0:
        failed.append("evaluation launched no B1")
    failed += _losses_fall(trainer)
    failed += _resume_failures(torch, args, VIT224_ARGS, ckdir)
    failed += check_vit_step(torch, trainer, batch=8, tag="imagenet",
                             tail=True)
    readings = _image_readings(torch, trainer, "vit_tiny imagenet-224 bf16, "
                               "batch 32", card, VIT224_TRAIN_FLOPS)
    readings["launches"] = {n: train[f"{n}_bf16"] for n in FLASH_NAMES}
    readings["launches_fp32"] = {n: train[f"{n}_fp32"] for n in FLASH_NAMES}
    return readings, failed, trainer


def _peak_step_mb(torch, step, x, y) -> float:
    """Peak memory allocated (MB) over one call of ``step``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(x, y)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


REMAT_STEPS = 5  # steps timed with and without --remat (CUDA events)


def _remat_pair(torch, trainer, batch, dtype) -> dict:
    """One step of a copy of ``trainer``'s model from its weights on its
    first ``batch`` images, without and with remat (the kernels' path,
    cuDNN deterministic), after the peak memory of one step and the p50
    of REMAT_STEPS timed ones → {"plain"|"remat": (loss, grads, peak MB,
    step ms)}."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    images, labels = trainer.train_split
    x = torch.from_numpy(np.array(images[:batch])).to(trainer.device)
    y = torch.from_numpy(labels[:batch]).to(trainer.device)
    src = trainer.state.model
    kw = ({"depth": len(src.block_names)} if hasattr(src, "block_names")
          and trainer.config.model.startswith("vit") else {})
    out = {}
    for label, remat in (("plain", False), ("remat", True)):
        model = get_model(trainer.config.model,
                          num_classes=trainer.num_classes,
                          side=images.shape[1], in_channels=3, remat=remat,
                          **kw)
        model.load_state_dict(src.state_dict())
        model = model.to(trainer.device)
        state = TrainState(0, model, make_optimizer(
            model.parameters(), "sgd", lr=0.01, momentum=0.9))
        step = make_train_step(state, reduce=lambda t: t,
                               compute_dtype=dtype)
        peak = _peak_step_mb(torch, step, x, y)
        ms = float(np.median(_timed_steps(torch, step, [(x, y)] * REMAT_STEPS)))
        model.load_state_dict(src.state_dict())  # the steps moved them
        m = step(x, y)
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        out[label] = (float(m.loss), grads, peak, ms)
        del model, state, step
        torch.cuda.empty_cache()
    return out


def check_remat224(torch, card, small, tmp, resnet, vit) -> tuple[dict, list]:
    """10c: --remat. ViT-Tiny at 224² (bf16, batch 32) and ResNet-50
    (fp32, batch 64): one step with remat against one without, from the
    trained weights, within the same limits (STEP_TOL bf16 /
    CNN_STEP_TOL), and the peak memory of each (remat must lower it);
    then a short ViT run with --remat through main(): B1 = 2 x depth x
    steps in training, B2 = B3 = depth x steps."""
    import torch.backends.cudnn as cudnn

    readings, failed = {}, []
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for label, trainer, batch, dtype, tol in (
                ("vit_tiny bf16", vit, 32, torch.bfloat16,
                 dict(STEP_TOL["bf16"], loss=VIT_BF16_LOSS_TOL)),
                ("resnet50 fp32", resnet, 64, torch.float32, CNN_STEP_TOL)):
            pair = _remat_pair(torch, trainer, batch, dtype)
            (l0, g0, m0, t0), (l1, g1, m1, t1) = pair["plain"], pair["remat"]
            per = {n: float((g1[n] - g0[n]).norm()
                            / g0[n].norm().clamp_min(1e-30)) for n in g0}
            grad = (sum(float((g1[n] - g0[n]).norm()) ** 2 for n in g0)
                    / sum(float(g0[n].norm()) ** 2 for n in g0)) ** 0.5
            loss = abs(l1 - l0) / abs(l0)
            leaf = max(per.items(), key=lambda x: x[1])
            ok = (loss <= tol["loss"] and grad <= tol["grad"]
                  and leaf[1] <= tol["leaf"])
            log(f"[imagenet] 10c {label}, one step with --remat vs without "
                f"(batch {batch}): loss {l1:.6f} vs {l0:.6f}; loss rel "
                f"{loss:.2e}, gradient rel {grad:.2e}, worst leaf "
                f"{leaf[1]:.2e} ({leaf[0]}) (limits {tol}); peak memory "
                f"{m1:.0f} MB with remat, {m0:.0f} MB without "
                f"({m1 / m0:.3f}); step p50 {t1:.2f} ms with remat, "
                f"{t0:.2f} ms without ({t1 / t0:.3f})")
            readings[label] = {"peak_mb_remat": m1, "peak_mb": m0,
                               "step_ms_remat": t1, "step_ms": t0}
            if not ok:
                failed.append(f"{label}: the remat step differs")
            if not m1 < m0:
                failed.append(f"{label}: remat did not lower peak memory")
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    args = ["--data_root", small, "--checkpoint_dir", f"{tmp}/remat",
            "--remat", "--epochs", "1"]
    trainer, _, train, _ = _launches_apart(torch, args, VIT224_ARGS)
    depth = len(trainer.state.model.block_names)
    steps = trainer.steps_per_epoch
    log(f"[imagenet] 10c vit_tiny --remat through main(), {steps} steps: "
        f"training launches {train} (B1 want 2 x depth x steps = "
        f"{2 * depth * steps}, B2/B3 {depth * steps})")
    want = {"flash_attn_fwd": 2 * depth * steps,
            "flash_attn_dq": depth * steps, "flash_attn_dkv": depth * steps}
    for n, w in want.items():
        if train[f"{n}_bf16"] != w:
            failed.append(f"--remat: {n} {train[f'{n}_bf16']} launches, "
                          f"not {w}")
    readings["launches"] = {n: train[f"{n}_bf16"] for n in FLASH_NAMES}
    return readings, failed


def check_profile_dir(torch, small, tmp) -> list:
    """10d: --profile_dir on a short 10b run (2 steps): the chrome trace
    rank 0 writes names B1's kernel."""
    import os

    prof = f"{tmp}/prof"
    _train(["--data_root", small, "--checkpoint_dir", f"{tmp}/prof_ck",
            "--epochs", "1", "--eval_every", "0", "--profile_dir", prof],
           VIT224_ARGS)
    names = os.listdir(prof) if os.path.isdir(prof) else []
    events = []
    if names:
        with open(os.path.join(prof, names[0])) as f:
            events = json.load(f).get("traceEvents", [])
    b1 = sorted({e.get("name", "")[:60] for e in events
                 if "fwd_sm90" in e.get("name", "")})
    log(f"[imagenet] 10d --profile_dir wrote {names}: {len(events)} events, "
        f"B1 kernel names {b1}")
    return [] if names == ["trace_rank0.json"] and b1 else [
        "--profile_dir's trace does not name B1's kernel"]


def check_trainer_flags(torch, tmp) -> list:
    """10e: --no_shuffle and --num_classes on a short SimpleCNN run: the
    first batch is the unshuffled indices' (rows 0..63), the head has
    --num_classes outputs."""
    trainer, _ = _train(["--synthetic_size", "640", "--epochs", "1",
                         "--no_shuffle", "--num_classes", "12",
                         "--checkpoint_dir", f"{tmp}/flags"])
    first = next(iter(trainer.loader.epoch(0)))
    labels = trainer.train_split.labels
    order = trainer.loader.sampler.shard_indices(0)
    head = trainer.state.model.state_dict()["fl.weight"].shape[0]
    same = bool(np.array_equal(first.labels.cpu().numpy(), labels[:64])
                and np.array_equal(order, np.arange(len(order))))
    log(f"[imagenet] 10e --no_shuffle --num_classes 12: the first batch is "
        f"rows 0..63 {same}, head outputs {head}")
    return [] if same and head == 12 else ["--no_shuffle / --num_classes"]


def check_and_time_flash(torch, shape, prefix, *, check_batch=None,
                         plain_batch=None, seed=224) -> dict:
    """B1-B3 alone at ``shape`` (label, B, T, S, H, D, causal), bf16 and
    fp32: each held to FLASH_TOL against its plain version (out, lse, dq,
    dk, dv) at ``check_batch`` rows of the batch (all when None), then
    timed at the whole batch with their bound and SDPA's forward and
    whole backward (_time_flash, the plain version in chunks of
    ``plain_batch``) → {f"{prefix}_bf16"|f"{prefix}_fp32": ...}."""
    import torch.nn.functional as F

    from ddp_tpu_torch.ops import flash as fl

    label, B, T, S, H, D, causal = shape
    out, failed = {}, []
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q, k, v, dout, dlse = _flash_inputs(torch, check_batch or B, T, S, H,
                                            D, dtype, seed=seed)
        got = _with_grads(torch, lambda *a: fl.flash_attention_with_lse(
            *a, causal), q, k, v, dout, dlse)
        want = _with_grads(torch, lambda *a: fl.attention_with_lse_reference(
            *a, causal), q.float(), k.float(), v.float(), dout.float(), dlse)
        errs = {}
        for name, keys in (("flash_attn_fwd", ("out", "lse")),
                           ("flash_attn_dq", ("dq",)),
                           ("flash_attn_dkv", ("dk", "dv"))):
            errs[name] = 0.0
            for key in keys:
                ok, text = _compare(torch, got[key], want[key],
                                    FLASH_TOL[dname])
                log(f"[flash] {dname} {label} (B {check_batch or B}): {key}: "
                    f"{text}" + ("" if ok else "  <-- FAILS"))
                if not ok:
                    failed.append(f"{dname} {key}")
                errs[name] = max(errs[name], float(
                    (got[key].float() - want[key].float()).abs()
                    .nan_to_num(0.0).max()))
        del q, k, v, dout, dlse, got, want
        torch.cuda.empty_cache()
        out[f"{prefix}_{dname}"] = _time_flash(torch, F, fl, dtype, dname,
                                               errs, shape, plain_batch)
    if failed:
        raise AssertionError(f"B1-B3 at {label} vs plain: {failed}")
    return out


def check_imagenet(torch, card) -> dict:
    """Phase 10, the ImageNet family at 224² on the synthetic set: 10a
    ResNet-50, 10b ViT-Tiny through B1-B3 at T 3137, 10c --remat, 10d
    --profile_dir, 10e --no_shuffle / --num_classes, 10f B1-B3 timed at
    T 3137. Every reading is printed before any raise."""
    import tempfile

    t0 = time.perf_counter()
    failed, readings = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_in_") as tmp:
        data, small = f"{tmp}/imagenet", f"{tmp}/imagenet_small"
        secs = write_imagenet(data, IMAGENET_TRAIN)
        write_imagenet(small, IMAGENET_SMALL)
        log(f"[imagenet] the synthetic 224² set: {IMAGENET_TRAIN} train + "
            f"{IMAGENET_TRAIN // 4} test images written in {secs:.1f} s")
        s0 = time.perf_counter()

        def lap(label):
            nonlocal s0
            log(f"[imagenet] {label}: {time.perf_counter() - s0:.1f} s")
            s0 = time.perf_counter()

        readings["resnet50"], bad, resnet = check_resnet50(torch, card,
                                                           data, tmp)
        failed += [f"10a: {b}" for b in bad]
        lap("10a")
        readings["vit"], bad, vit = check_vit224(torch, card, data, tmp)
        failed += [f"10b: {b}" for b in bad]
        lap("10b")
        readings["remat"], bad = check_remat224(torch, card, small, tmp,
                                                resnet, vit)
        failed += [f"10c: {b}" for b in bad]
        del resnet, vit
        torch.cuda.empty_cache()
        lap("10c")
        failed += [f"10d: {b}" for b in check_profile_dir(torch, small, tmp)]
        failed += [f"10e: {b}" for b in check_trainer_flags(torch, tmp)]
        lap("10d and 10e")
    readings["flash"] = check_and_time_flash(torch, VIT224_SHAPE, "vit224")
    lap("10f")
    log(f"[imagenet] phase 10: {time.perf_counter() - t0:.1f} s on {card}")
    if failed:
        raise AssertionError(f"phase 10: {failed}")
    return readings


# Phase 11: the long-context classifier at the repository's full width
# (``ddp_tpu/train/config.py``'s defaults and README.md's command: d_model
# 64, depth 2, 4 heads so head dim 16, seq_dim 16, 10 classes, T 8192,
# batch 32 a rank), non-causal, at a seq world of 1; Adam 1e-3 (the JAX
# seq trainer tests' recipe); 128 sequences = 4 steps an epoch.
LC_ARGS = ["--model", "long_context", "--seq_len", "8192", "--seq_dim", "16",
           "--batch_size", "32", "--synthetic_size", "128", "--epochs", "2",
           "--optimizer", "adam", "--lr", "1e-3", "--log_interval", "1000"]
LC_SHAPE = ("long_context non-causal T=S=8192 D 16", 32, 8192, 8192, 4, 16,
            False)
# 11c's plain version runs over the batch in chunks of 4: at B 32 its
# fp32 logits alone would take 34 GB.
LC_PLAIN_BATCH = 4
# The exponentials of one B1 at LC_SHAPE, B·H·T·S, against the H100's
# exponential unit, ~3.9 TFLOP/s (FlashAttention-3, Shah et al. 2024):
# a reading beside the bound, not the bound.
H100_EXP_PER_S = 3.9e12
# 11d: bench.py run_lm_long_bench (:584), run_lm_bench's model at T 8192:
# vocab 8192, d 1024, depth 4 (of 8: a cut, since phase 14 joined the
# script), 8 heads (D 128), batch 2, bf16, Adam 3e-4, causal; 8
# sequences = 4 steps.
LM_LONG_ARGS = [
    "--model", "causal_lm", "--dataset", "synthetic_seq",
    "--synthetic_size", "8", "--seq_len", "8192", "--vocab_size", "8192",
    "--model_dim", "1024", "--model_depth", "4", "--num_heads", "8",
    "--batch_size", "2", "--epochs", "1", "--optimizer", "adam",
    "--lr", "3e-4", "--compute_dtype", "bfloat16",
]
LM_LONG_SHAPE = ("LM causal T=S=8192 D 128", 2, 8192, 8192, 8, 128, True)
LM_LONG_STEP_DEPTH = 2  # 11d's kernel-vs-plain step: 4.3 GB of logits a layer
# 11e: the BPE tokenizer trained on this repository's README.md.
BPE_ARGS = ["--model", "causal_lm", "--dataset", "text", "--vocab_size",
            "1024", "--seq_len", "128", "--batch_size", "8", "--optimizer",
            "adam", "--lr", "3e-3"]
# 11f: run_lm_bench's width (vocab 8192, d 1024, 8 heads so D 128, T
# 2048), cut to depth 2 and 8 sequences (2 steps an epoch at a global
# batch of 4, 2 epochs): world 2 (per-rank batch 2) against world 1
# (batch 4). fp32 and --deterministic, so that the runs differ only in the
# order of their sums; SGD, so that a gradient divided twice moves the
# parameters (Adam's update would not see the scale).
W2_ARGS = ["--model", "causal_lm", "--synthetic_size", "8", "--seq_len",
           "2048", "--vocab_size", "8192", "--model_dim", "1024",
           "--model_depth", "2", "--num_heads", "8", "--epochs", "2",
           "--optimizer", "sgd", "--lr", "0.1", "--compute_dtype", "float32",
           "--deterministic"]
# The CUDA kernel of each of B1-B3 in each dtype, as a profiler trace
# names it.
FLASH_KERNELS = {f"{n}_{d}": f"{n.removeprefix('flash_attn_')}_{k}"
                 for n in FLASH_NAMES
                 for d, k in (("bf16", "sm90"), ("fp32", "tf32"))}


def _readme() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "README.md")


def check_lc_training(torch, card, tmp) -> tuple[dict, list, object]:
    """11a: ``main()`` with LC_ARGS in bf16 and fp32: B1 = B2 = B3 = depth
    x steps in training in the run's dtype (evaluation apart), none in
    the other, nothing routed; losses finite and falling; resume exact;
    the step p50, sequences/s and tokens/s, the busy share and B1-B3's
    share of device time; then one bf16 epoch with --seq_strategy
    ulysses launching the same kernels → (readings, failures, the bf16
    trainer)."""
    from ddp_tpu_torch.ops import flash as fl

    readings, failed, kept = {}, [], None
    for dname, d in (("bfloat16", "bf16"), ("float32", "fp32")):
        ckdir = f"{tmp}/lc_{d}"
        args = ["--checkpoint_dir", ckdir, "--compute_dtype", dname]
        trainer, _, train, evals = _launches_apart(torch, args, LC_ARGS)
        routed = fl.flash_attention.plain_routed
        other = "fp32" if d == "bf16" else "bf16"
        depth = trainer.spec.depth
        steps = trainer.steps_per_epoch * trainer.config.epochs
        log(f"[lc] 11a long_context {d}, T {trainer.config.seq_len}, head dim "
            f"{trainer.spec.d_model // trainer.spec.num_heads}, depth "
            f"{depth}, {steps} steps: training launches {train} (depth x "
            f"steps = {depth * steps}), evaluation {evals}, routed {routed}")
        for h in trainer.history:
            log(_epoch_line(h, f"long_context {d},").replace("[cnn]", "[lc]"))
        failed += [f"{d}: {n} {train[f'{n}_{d}']} training launches, not "
                   f"{depth * steps}" for n in FLASH_NAMES
                   if train[f"{n}_{d}"] != depth * steps]
        if routed or any(train[f"{n}_{other}"] for n in FLASH_NAMES):
            failed.append(f"{d}: routed {routed}, launches {train}")
        failed += [f"{d}: {f}" for f in _losses_fall(trainer)]
        failed += [f"{d}: {f}" for f in
                   _resume_failures(torch, args, LC_ARGS, ckdir)]
        h, out = trainer.history[-1], {}
        busy = profile_cnn_epoch(torch, trainer, f"long_context {d}",
                                 PROFILE_STEPS, out)
        rate = trainer.global_batch_size / h["step_p50_s"]
        T = trainer.config.seq_len
        log(f"[time] long_context {d} ({card}): step p50 "
            f"{h['step_p50_s'] * 1e3:.3f} ms, {rate:.2f} sequences/s, "
            f"{rate * T:.1f} tokens/s at the p50 step "
            f"({h['images_per_s_per_card'] * T:.1f} over the epoch), busy "
            f"share {busy:.3f}, B1-B3 {out['flash_share']:.3f} of device "
            f"time ({out['device_ms']:.3f} ms of kernels a step)")
        readings[d] = dict(step_p50_ms=h["step_p50_s"] * 1e3,
                           sequences_per_s=rate, tokens_per_s=rate * T,
                           busy=busy, **out,
                           launches={n: train[f"{n}_{d}"]
                                     for n in FLASH_NAMES})
        if d == "bf16":
            kept = trainer
        else:
            del trainer
        torch.cuda.empty_cache()
    args = ["--checkpoint_dir", f"{tmp}/lc_ulysses", "--compute_dtype",
            "bfloat16", "--seq_strategy", "ulysses", "--epochs", "1"]
    trainer, _, train, _ = _launches_apart(torch, args, LC_ARGS)
    steps = trainer.steps_per_epoch
    log(f"[lc] 11a --seq_strategy ulysses, bf16, {steps} steps: training "
        f"launches {train}, routed {fl.flash_attention.plain_routed}")
    if any(train[f"{n}_bf16"] != kept.spec.depth * steps
           for n in FLASH_NAMES) or fl.flash_attention.plain_routed:
        failed.append(f"ulysses: launches {train}")
    readings["ulysses_bf16"] = {n: train[f"{n}_bf16"] for n in FLASH_NAMES}
    del trainer
    torch.cuda.empty_cache()
    return readings, failed, kept


def time_lc_attention(torch) -> dict:
    """11c: B1-B3 alone at LC_SHAPE, bf16 and fp32, held to FLASH_TOL at
    B 2 and timed at B 32 (the plain version in chunks of
    LC_PLAIN_BATCH), with the exponentials one B1 computes beside its
    bound; then the same at 11d's LM_LONG_SHAPE (B 2, T 8192, H 8, D 128,
    causal)."""
    out = check_and_time_flash(torch, LC_SHAPE, "long_context", check_batch=2,
                               plain_batch=LC_PLAIN_BATCH, seed=11)
    out.update(check_and_time_flash(torch, LM_LONG_SHAPE, "lm_long", seed=12))
    _, B, T, S, H, D, _ = LC_SHAPE
    exps = B * H * T * S
    for d in ("bf16", "fp32"):
        b1 = out[f"long_context_{d}"]["flash_attn_fwd"]
        log(f"[flash] B1 {d} at {LC_SHAPE[0]} B {B}: {exps:.3g} "
            f"exponentials, {exps / H100_EXP_PER_S * 1e3:.3f} ms at the "
            f"exponential unit's ~3.9 TFLOP/s (a reading); bound "
            f"{b1['bound_ms']:.3f} ms ({b1['bound_by']}); kernel "
            f"{b1['ms']:.3f} ms")
        out[f"long_context_{d}"]["flash_attn_fwd"]["exp_ms"] = \
            exps / H100_EXP_PER_S * 1e3
    return out


def check_lm_long(torch, card, tmp) -> tuple[dict, list]:
    """11d: the causal LM at LM_LONG_ARGS through main(): B1 = B2 = B3 =
    depth x steps in training (evaluation apart), nothing routed, the
    loss finite; tokens/s, step p50 and the estimated MFU (bench.py
    run_lm_bench's flops per token); then one step at depth 2 through
    the kernels against the plain attention (compare_step's bf16 gate,
    peak memory printed) → (readings, failures)."""
    import types

    from ddp_tpu_torch.models.lm import truncated_draft
    from ddp_tpu_torch.ops import flash as fl

    trainer, _, train, evals = _launches_apart(
        torch, ["--checkpoint_dir", f"{tmp}/lm_long"], LM_LONG_ARGS,
        cls="LMTrainer")
    routed = fl.flash_attention.plain_routed
    spec = trainer.spec
    steps = trainer.steps_per_epoch * trainer.config.epochs
    h = trainer.history[-1]
    tokens = trainer.global_batch_size * spec.total_len / h["step_p50_s"]
    mfu = tokens * _lm_flops_per_token(spec) / H100_BF16_FLOPS
    log(f"[lm-long] 11d run_lm_long_bench's shape, {steps} steps: training "
        f"launches {train} (depth x steps = {spec.depth * steps}), "
        f"evaluation {evals}, routed {routed}; losses {h['loss']}")
    log(f"[time] lm T 8192 bf16 ({card}): step p50 "
        f"{h['step_p50_s'] * 1e3:.3f} ms, {tokens:.1f} tokens/s, est. MFU "
        f"{mfu:.4f}")
    failed = [f"{n}: {train[f'{n}_bf16']} training launches, not "
              f"{spec.depth * steps}" for n in FLASH_NAMES
              if train[f"{n}_bf16"] != spec.depth * steps]
    if (routed or not all(np.isfinite(h["loss"]))
            or any(train[f"{n}_fp32"] for n in FLASH_NAMES)):
        failed.append(f"routed {routed}, launches {train}, losses "
                      f"{h['loss']}")
    view = types.SimpleNamespace(
        model=truncated_draft(trainer.model, LM_LONG_STEP_DEPTH),
        spec=spec._replace(depth=LM_LONG_STEP_DEPTH), tokens=trainer.tokens,
        device=trainer.device, compute_dtype=trainer.compute_dtype)
    try:
        peak = compare_step(torch, view, "bf16", batch=2, gate="ratio")
    except AssertionError as e:
        failed.append(str(e))
        peak = {}
    del trainer, view
    torch.cuda.empty_cache()
    return dict(step_p50_ms=h["step_p50_s"] * 1e3, tokens_per_s=tokens,
                mfu=mfu, peak_mb=peak,
                launches={n: train[f"{n}_bf16"] for n in FLASH_NAMES},
                launches_fp32={n: train[f"{n}_fp32"] for n in FLASH_NAMES}
                ), failed


def check_bpe(torch, tmp) -> list:
    """11e: --dataset text on README.md at --vocab_size 1024 on the card,
    two epochs: tokenizer.json next to the checkpoints, byte-identical to
    the one a --device cpu run of the same command writes; --epochs 3
    resumes with the same file (bytes and mtime) and the same splits;
    the loss falls."""
    import os

    args = BPE_ARGS + ["--text_file", _readme()]
    card_dir, cpu_dir = f"{tmp}/bpe_card", f"{tmp}/bpe_cpu"
    t0 = time.perf_counter()
    first, _ = _train(args + ["--epochs", "2", "--checkpoint_dir", card_dir],
                      [])
    secs = time.perf_counter() - t0
    path = os.path.join(card_dir, "tokenizer.json")
    written, mtime = open(path, "rb").read(), os.stat(path).st_mtime_ns
    again, text = _train(args + ["--epochs", "3", "--checkpoint_dir",
                                 card_dir], [])
    cpu, _ = _train(args + ["--epochs", "1", "--device", "cpu",
                            "--checkpoint_dir", cpu_dir], [])
    cpu_bytes = open(os.path.join(cpu_dir, "tokenizer.json"), "rb").read()
    means = [h["train_loss"] for h in first.history + again.history]
    vocab = len(json.loads(written)["merges"]) + 256
    log(f"[bpe] 11e README.md at --vocab_size 1024: {vocab} ids, "
        f"{len(first.train_split.images)} train sequences of 128, "
        f"tokenizer.json {len(written)} bytes (the first run {secs:.1f} s, "
        f"training the vocabulary included); the CPU's file "
        f"{'byte-identical' if cpu_bytes == written else 'DIFFERS'}; "
        f"resumed: {'Resumed from checkpoint epoch 1' in text}, the file "
        f"{'unchanged' if open(path, 'rb').read() == written and os.stat(path).st_mtime_ns == mtime else 'CHANGED'}; "
        f"epoch mean losses {[round(m, 4) for m in means]}")
    failed = []
    if cpu_bytes != written:
        failed.append("the card's tokenizer.json differs from the CPU's")
    if ("Resumed from checkpoint epoch 1" not in text
            or open(path, "rb").read() != written
            or os.stat(path).st_mtime_ns != mtime
            or not np.array_equal(again.train_split.images,
                                  first.train_split.images)):
        failed.append("the resumed run did not reuse tokenizer.json")
    if not (len(means) == 3 and all(np.isfinite(means))
            and means[2] < means[1] < means[0]):
        failed.append(f"the loss does not fall: {means}")
    del first, again, cpu
    return failed


def _lm_world2_control(torch, argv) -> dict:
    """The world-2 run with its average divided by the world twice: two
    ranks in threads on the card (runtime/dist.ThreadWorld), each an
    LMTrainer's model, optimizer and tokens driven by the LM epoch runner
    over its strided shard, the bucket summed then halved once more →
    rank 0's final parameters."""
    from ddp_tpu_torch.runtime.dist import DistContext, ThreadWorld
    from ddp_tpu_torch.train import trainer as tr
    from ddp_tpu_torch.train.config import TrainConfig
    from ddp_tpu_torch.train.fast import make_lm_epoch_runner

    from ddp_tpu_torch.device import resolve_device

    config = TrainConfig.from_args(argv)
    device = resolve_device(config.device)
    tw = ThreadWorld(2)

    def rank_run(r):
        t = tr.LMTrainer(config, DistContext("gloo", r, 2, device))
        total = tw.reduce(r)
        run = make_lm_epoch_runner(
            t.model, t.optimizer, t.tokens, t.global_batch_size,
            compute_dtype=t.compute_dtype, seed=config.seed, rank=r, world=2,
            reduce=lambda x: total(x).div_(2))
        for epoch in range(config.epochs):
            run(epoch)
        return {k: v.detach().cpu() for k, v in t.model.state_dict().items()}

    return tw.run(rank_run)[0]


def _trace_kernel_counts(path) -> dict:
    """The launches of B1-B3's CUDA kernels (FLASH_KERNELS) that a
    ``--profile_dir`` chrome trace records."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f).get("traceEvents", [])
                 if e.get("cat") == "kernel"]
    return {key: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
            for key, k in FLASH_KERNELS.items()}


def check_lm_world2(torch, tmp) -> tuple[dict, list]:
    """11f: W2_ARGS at world 2 (--spawn 2 --backend gloo, both ranks on the
    one card, batch 2 each) against two world-1 runs of the same global
    batch and plan: batch 4, and batch 2 with --grad_accum_steps 2 (which
    sums the same two strided halves world 2's ranks do). They differ only
    in the order of their sums, and their distance is the limit (C13's
    rule): world 2's final parameters must be within it of the nearer
    (bitwise when it is 0); the same run with its average divided by the
    world twice must not be. Rank 0's --profile_dir trace counts its B1-B3
    launches: B2 = B3 = depth x steps in fp32, B1 at least that (the
    evaluation's forward adds to it), none in bf16 → (readings,
    failures)."""
    import os

    def final(name):
        return torch.load(f"{tmp}/{name}/epoch_1/state.pt",
                          weights_only=True)

    def diff(a, b):
        return max(float((a[k].float() - b[k].float()).abs().max())
                   for k in a)

    prof = f"{tmp}/w2_prof"
    world1 = {"w1_b4": ["--batch_size", "4"],
              "w1_b2_accum2": ["--batch_size", "2", "--grad_accum_steps",
                               "2"]}
    runs = dict(world1, w2_b2=["--batch_size", "2", "--spawn", "2",
                               "--backend", "gloo", "--profile_dir", prof])
    t0 = time.perf_counter()
    for name, extra in runs.items():
        _train(extra + ["--checkpoint_dir", f"{tmp}/{name}"], W2_ARGS)
    blobs = {name: final(name) for name in runs}
    steps = {name: b["step"] for name, b in blobs.items()}
    p = {name: b["params"] for name, b in blobs.items()}
    spread = diff(p["w1_b4"], p["w1_b2_accum2"])
    w2 = {ref: diff(p["w2_b2"], p[ref]) for ref in world1}
    control = _lm_world2_control(torch, W2_ARGS + CNN_DEVICE_ARGS + [
        "--batch_size", "2", "--checkpoint_dir", f"{tmp}/w2_control"])
    ctl = {ref: diff(control, p[ref]) for ref in world1}
    trace = f"{prof}/trace_rank0.json"
    launches = _trace_kernel_counts(trace) if os.path.exists(trace) else {}
    depth = int(W2_ARGS[W2_ARGS.index("--model_depth") + 1])
    want = depth * steps["w2_b2"]
    log(f"[lm-w2] 11f run_lm_bench's width at depth {depth}, "
        f"{sum(v.numel() for v in p['w1_b4'].values()) / 1e6:.1f} M "
        f"parameters, steps {steps} ({time.perf_counter() - t0:.1f} s); the "
        f"world-1 runs' distance {spread:.3e}; world 2 (--spawn 2 --backend "
        f"gloo) vs " + ", ".join(f"{ref} {v:.3e}" for ref, v in w2.items())
        + "; control, the world-2 average divided twice, vs "
        + ", ".join(f"{ref} {v:.3e}" for ref, v in ctl.items())
        + f"; rank 0's B1-B3 kernel launches in its trace {launches} "
        f"(depth x steps = {want})")
    failed = []
    if len(set(steps.values())) != 1:
        failed.append(f"the runs took different step counts {steps}")
    if not min(w2.values()) <= spread:
        failed.append("world 2 parts from world 1 by more than the spread")
    if min(ctl.values()) <= spread:
        failed.append("the check passes a world-2 average divided twice")
    if not (launches
            and launches["flash_attn_fwd_fp32"] >= want
            and launches["flash_attn_dq_fp32"] == want
            and launches["flash_attn_dkv_fp32"] == want
            and not any(launches[f"{n}_bf16"] for n in FLASH_NAMES)):
        failed.append(f"rank 0 launched {launches}, not B2 = B3 = {want} "
                      "in fp32")
    return dict(spread=spread, world2=w2, control=ctl, launches=launches,
                steps=steps["w2_b2"]), failed


def check_long_context(torch, card) -> dict:
    """Phase 11, the long-context slice: 11a the long-context classifier
    trained at full width through main(); 11b its step through B1-B3
    against the plain attention; 11c B1-B3 alone at its shape, timed;
    11d the causal LM at T 8192; 11e the BPE tokenizer; 11f the LM at
    world 2. Every reading is printed before any raise."""
    import tempfile

    from ddp_tpu_torch.ops import flash as fl

    t0 = s0 = time.perf_counter()
    failed, readings = [], {}

    def lap(label):
        nonlocal s0
        log(f"[lc] {label}: {time.perf_counter() - s0:.1f} s")
        s0 = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lc_") as tmp:
        readings["train"], bad, trainer = check_lc_training(torch, card, tmp)
        failed += [f"11a: {b}" for b in bad]
        lap("11a")
        rec = {}
        drop_tile = _drop_key_grad(torch, slice(512, 576))
        failed += [f"11b: {b}" for b in check_vit_step(
            torch, trainer, batch=2, tag="lc", controls={},
            gate_controls={"dK of keys 512-575 dropped": lambda q, k, v:
                           fl.attention_with_lse_reference(
                               q, drop_tile(k), v, False)[0]},
            tail=True, record=rec)]
        readings["step"] = rec
        del trainer
        torch.cuda.empty_cache()
        lap("11b")
        readings["flash"] = time_lc_attention(torch)
        lap("11c")
        readings["lm_long"], bad = check_lm_long(torch, card, tmp)
        failed += [f"11d: {b}" for b in bad]
        lap("11d")
        failed += [f"11e: {b}" for b in check_bpe(torch, tmp)]
        lap("11e")
        readings["world2"], bad = check_lm_world2(torch, tmp)
        failed += [f"11f: {b}" for b in bad]
        lap("11f")
    log(f"[lc] phase 11: {time.perf_counter() - t0:.1f} s on {card}")
    if failed:
        raise AssertionError(f"phase 11: {failed}")
    return readings


# Phase 12: the sequence models across ranks, every rank on the one card
# (nccl takes one rank a card), through the CLI's --spawn N --backend
# gloo: the exchanges are staged through pinned host buffers
# (runtime/dist.DistComm). The step times are those of N processes
# sharing one card, and of every run sharing it too (one wave, half of it
# WAVE_STAGGER s late, 12d's world of ranks beside them): no scaling
# figure.
# Cuts, for the phase's time: one epoch of 2 steps each (12a 64
# sequences, 12b 4, 12c 32); 12a
# in bf16; 12b at depth 2 (of 8), 12c at depth 2 (of 5m's 4: block 2
# routed).
GLOO = ["--backend", "gloo"]
P12_LC_ARGS = list(LC_ARGS) + ["--mesh_seq", "4", "--compute_dtype",
                               "bfloat16"]
P12_LC_ARGS[P12_LC_ARGS.index("--epochs") + 1] = "1"
P12_LC_ARGS[P12_LC_ARGS.index("--synthetic_size") + 1] = "64"
P12_LM_ARGS = list(LM_LONG_ARGS)
P12_LM_ARGS[P12_LM_ARGS.index("--synthetic_size") + 1] = "4"
P12_LM_ARGS[P12_LM_ARGS.index("--model_depth") + 1] = "2"
P12_MOE_ARGS = list(TRAIN_MOE_ARGS)
P12_MOE_ARGS[P12_MOE_ARGS.index("--synthetic_size") + 1] = "32"
P12_MOE_ARGS[P12_MOE_ARGS.index("--model_depth") + 1] = "2"
P12_RUNS = {  # name: (base, extra flags, world)
    "12a_ring": (P12_LC_ARGS, [], 4),
    "12a_ulysses": (P12_LC_ARGS, ["--seq_strategy", "ulysses"], 4),
    "12b_seq2": (P12_LM_ARGS, ["--mesh_seq", "2"], 2),
    "12b_model2": (P12_LM_ARGS, ["--mesh_model", "2"], 2),
    "12b_model2_seq2": (P12_LM_ARGS, ["--mesh_model", "2", "--mesh_seq",
                                      "2"], 4),
    "12c_expert2": (P12_MOE_ARGS, ["--mesh_expert", "2"], 2),
}
# 12d's spawned check: W2_ARGS's width (d 1024, 8 heads, vocab 8192, T
# 2048, depth 2), fp32 SGD 0.1, --deterministic, 2 steps of the global
# batch 4, at --mesh_seq 2 (world 2: the causal ring and the shifted
# targets) against world 1. The limit on their final parameters'
# distance (the runs differ in the order of their sums); the control,
# the gradient divided by the world once more, must part by more.
P12_SPAWN_ARGS = list(W2_ARGS) + ["--batch_size", "4"]
P12_SPAWN_ARGS[P12_SPAWN_ARGS.index("--synthetic_size") + 1] = "8"
P12_SPAWN_ARGS[P12_SPAWN_ARGS.index("--epochs") + 1] = "1"
P12_SPAWN_WORLD = 2
P12_PARAM_ATOL = 1e-5
# The runs, 12d's spawned one and 12d's world of processes start at once
# (on an H100 at 700 W: 117.9 s so, 125.4 s in two waves; the start-up
# of ~30 processes on the host's 8 cores is half of it). A run is killed,
# and fails the phase, past P12_RUN_TIMEOUT s; 12d's world past
# P12D_DEADLINE s from its start (both 2-3x their time on the card).
P12_RUN_TIMEOUT = 300
P12D_DEADLINE = 420
# Each wave starts every other run WAVE_STAGGER s after the rest, so that
# the halves' training (where a process holds the most of the card's
# memory) falls apart: launched at once (on an H100 80GB HBM3 at 700 W)
# their peaks met past the card's 80 GB once the trainer's profiler no
# longer slowed their start; staggered, the waves peaked at 49.1 and 61.9
# GB.
WAVE_STAGGER = 25
# The ring hops' block shapes (label, B, T, S, H, D, causal): 12a's past
# hop (T 8192 over 4 ranks) and 12b's (T 8192 over 2), unmasked.
HOP12A_SHAPE = ("12a ring hop T=S=2048 D 16", 32, 2048, 2048, 4, 16, False)
HOP12B_SHAPE = ("12b ring hop T=S=4096 D 128", 2, 4096, 4096, 8, 128, False)
# 12d, one fp32 step from the same weights: each mesh over a gloo world of
# P12_WORLD processes on the card (the data axis the rest), B1-B3 in
# fp32, against world 1 through the plain attention, STEP_TOL["fp32"].
# Cuts: depth 2; the long-context batch 32 -> 2; the LM's 2 -> 1 a
# replica, at T 4096 (8192 until phase 14 joined the script); the routed
# LM's 8 -> 1 a replica (its depth 4 -> 2: block 2 routed).
P12_WORLD = 4
P12_LC = dict(num_classes=10, total_len=8192, d_in=16, d_model=64, depth=2,
              num_heads=4)
P12_LM = dict(vocab_size=8192, total_len=4096, d_model=1024, depth=2,
              num_heads=8)
P12_MOE = dict(vocab_size=8192, total_len=2048, d_model=1024, depth=2,
               num_heads=8, num_kv_heads=2, num_experts=8, moe_every=2)
# label: (family, mesh axes, control)
P12_CHECKS = {
    "12a ring seq 4": ("lc", dict(seq=4), None),
    "12a ring seq 4, a dropped past hop": ("lc", dict(seq=4), "drop_hop"),
    "12a ulysses seq 4": ("lc_ulysses", dict(seq=4), None),
    "12b seq 2": ("lm", dict(seq=2), None),
    "12b model 2": ("lm", dict(model=2), None),
    "12b model 2, the model reduction counted twice": ("lm", dict(model=2),
                                                       "double"),
    "12b model 2 x seq 2": ("lm", dict(model=2, seq=2), None),
    "12c expert 2": ("moe", dict(expert=2), None),
    "12c expert 2, slots to the wrong owner": ("moe", dict(expert=2),
                                               "misroute"),
}


# Phase 13, FSDP and ZeRO, rides phase 12's wave and 12d's world (it
# starts no world of its own: the start-up of ~30 processes on the host's
# 8 cores is half of phase 12). 13a: the LM at P12_LM_ARGS' width (d 1024,
# 8 heads, vocab 8192, T 8192, bf16, depth 2) at --mesh_fsdp 2 --mesh_seq
# 2 --spawn 4; 13b: ViT-Tiny at VIT_ARGS' width (CIFAR-100, T 65, bf16,
# depth 12) under --parallel zero --zero_gather_dtype bf16 --spawn 2.
# Both --backend gloo, every rank on the one card: four (two) processes
# sharing it through host-staged exchanges, no scaling figure. Cuts: one
# epoch of 2 steps; a sequence a rank (13a: 4 sequences, the global batch
# 2) and 64 images a rank (13b: 256 images, the global batch 128), so
# that the wave's ~40 processes fit the card's 80 GB (at 2 and 256 a rank
# a run died of CUDA's out of memory at its checkpoint).
P13A_ARGS = list(P12_LM_ARGS)
P13A_ARGS[P13A_ARGS.index("--batch_size") + 1] = "1"
P13B_ARGS = list(VIT_ARGS) + ["--model_depth", "12", "--parallel", "zero",
                              "--zero_gather_dtype", "bf16"]
P13B_ARGS[P13B_ARGS.index("--synthetic_size") + 1] = "256"
P13B_ARGS[P13B_ARGS.index("--batch_size") + 1] = "64"
P13B_ARGS[P13B_ARGS.index("--epochs") + 1] = "1"
P12_RUNS.update({
    "13a_fsdp2_seq2": (P13A_ARGS, ["--mesh_fsdp", "2", "--mesh_seq", "2"],
                       4),
    "13b_vit_zero": (P13B_ARGS, [], 2),
})
# 13c, in 12d's world: one fp32 step from the same weights through B1-B3
# (fp32) under FSDP and ZeRO against world 1's exact step, STEP_TOL["fp32"]:
# the LM (P12_LM) at fsdp 2 x seq 2, fsdp 2 x model 2 and data 2 x fsdp 2,
# and under zero at data 4 and data 2 x model 2 with the in-step clip
# (P13_CLIP engages: the reference's gradient is clipped alike); ViT-Tiny
# (P13_VIT, T 65) under zero at data 4 with the fp32 and the bf16 gather,
# the bf16 gather's master held to the fp32 gather's parameters within
# P13_MASTER_ATOL. Controls that must fail: the reduce-scatter's 1/n
# dropped, the clip's sum over model counting the replicated leaves too,
# the update at the neighbour's shard offset. Cuts: the LM at T 2048 (12d's
# is at 8192: phase 13 had to pay for its wave's place), depth 2; 1 row
# (image) a replica, so the meshes of 4 replicas take the "lm4" batch of
# 4 rows, whose exact step is the mean of two world-1 steps of 2 rows.
P13_LM = dict(P12_LM, total_len=2048)
P13_CLIP = 1e-3
P13_MASTER_ATOL = 1e-6
P13_VIT = dict(num_classes=100, side=32, in_channels=3, depth=2)
P12_CHECKS.update({
    "13c lm fsdp 2 x seq 2": ("lm2", dict(fsdp=2, seq=2), None),
    "13c lm fsdp 2 x model 2": ("lm2", dict(fsdp=2, model=2), None),
    "13c lm data 2 x fsdp 2": ("lm4", dict(fsdp=2), None),
    "13c lm data 2 x fsdp 2, the reduce-scatter's 1/n dropped":
        ("lm4", dict(fsdp=2), "drop_scale"),
    "13c lm zero data 4": ("lm4_zero", {}, None),
    "13c lm zero data 2 x model 2": ("lm2_zero", dict(model=2), None),
    "13c lm zero data 2 x model 2, the clip's model sum doubled":
        ("lm2_zero", dict(model=2), "clip_model"),
    "13c vit zero data 4": ("vit_zero", {}, None),
    "13c vit zero data 4, the neighbour's shard offset":
        ("vit_zero", {}, "offset"),
    "13c vit zero data 4, bf16 gather": ("vit_zero_bf16", {}, None),
})


# Phase 14, GSPMD for the image family, rides phase 12's wave and 12d's
# world too. 14a: ViT-Tiny at 7a's width (CIFAR-100, 32², patch 4, T 65,
# d 192, depth 12, 3 heads, bf16) at --mesh_model 3 --spawn 3: whole
# heads, one a rank, so B1-B3 run on [b, 65, 1, 64]; 14b: vit_moe_tiny
# (7c's: 8 experts, top-2, depth 4) at --mesh_expert 2 --spawn 2, 4
# experts a rank; 14c: ResNet-18 at 7b's recipe on CIFAR-10 at
# --mesh_fsdp 2 and under --zero1, --spawn 2 each. Cuts: one epoch of 2
# steps each, 64 images a data replica.
P14A_ARGS = list(VIT_ARGS) + ["--model_depth", "12"]
P14B_ARGS = list(VIT_MOE_ARGS)
P14C_ARGS = list(RESNET_ARGS)
for _args, _size in ((P14A_ARGS, "128"), (P14B_ARGS, "256"),
                     (P14C_ARGS, "256")):
    _args[_args.index("--synthetic_size") + 1] = _size
    _args[_args.index("--batch_size") + 1] = "64"
    _args[_args.index("--epochs") + 1] = "1"
P12_RUNS.update({
    "14a_vit_model3": (P14A_ARGS, ["--mesh_model", "3"], 3),
    "14b_moe_expert2": (P14B_ARGS, ["--mesh_expert", "2"], 2),
    "14c_resnet_fsdp2": (P14C_ARGS, ["--mesh_fsdp", "2"], 2),
    "14c_resnet_zero1": (P14C_ARGS, ["--zero1"], 2),
})
# 14a's heads a rank (whole heads: 3 over --mesh_model 3).
P14A_SHAPE = "64x65x1x64"
# 14d, in 12d's world: one fp32 step (SGD 0.1, B1-B3 in fp32) of each
# GSPMD mesh from the same seeded weights on the global batch of
# P14_ROWS images (so 1 a data replica at data 4, 2 at model 2 x fsdp
# 2), against world 1's exact step on it (the plain attention; the MoE
# with the mesh's global routing replayed, ResNet with its ReLU masks
# tied to the mesh's), STEP_TOL["fp32"] on the loss, the whole gradient
# and the worst leaf; under --zero1 the updated parameters within
# P12_PARAM_ATOL too. Controls that must fail: BatchNorm by each rank's
# own moments, MoE capacity and slot order per rank, an fsdp gradient
# unscaled by its axis, a --zero1 update without the parameter
# all-gather. Cuts: ViT-Tiny and vit_moe_tiny at depth 2 (block 2
# routed), the MoE at capacity factor P14_MOE_CF (tokens drop).
# B1-B3 alone at 14a's shape: 64 images a rank, T 65, one head of 64.
P14A_FLASH_SHAPE = ("14a ViT-Tiny one head a rank T=S=65 D 64", 64, 65, 65,
                    1, 64, False)
P14_ROWS = 4
P14_MOE_CF = 1.0
P14_CHECKS = {  # label: (family, mesh axes, zero1, control)
    # ViT-Tiny's 3 heads do not divide model 2: qkv is gathered.
    "14d vit model 2 x fsdp 2": ("vit14", dict(model=2, fsdp=2), False,
                                 None),
    "14d vit model 2 x fsdp 2, an fsdp gradient unscaled":
        ("vit14", dict(model=2, fsdp=2), False, "drop_scale"),
    "14d vit_moe expert 2 x data 2": ("moe14", dict(expert=2), False, None),
    "14d vit_moe expert 2 x data 2, capacity and slots per rank":
        ("moe14", dict(expert=2), False, "local_routing"),
    "14d resnet18 fsdp 4": ("rn14", dict(fsdp=4), False, None),
    "14d resnet18 fsdp 4, BN by the rank's own moments":
        ("rn14", dict(fsdp=4), False, "local_bn"),
    "14d simple_cnn zero1 data 4": ("cnn14", {}, True, None),
    "14d simple_cnn zero1 data 4, no parameter all-gather":
        ("cnn14", {}, True, "skip_gather"),
    "14d vit zero1 data 4": ("vit14", {}, True, None),
}
# 14e, in 12d's world: shard_decode_attention at model 2 (data 2) and 4,
# B4 and B5, at phase 3's shapes (S 8, H 8, Dh 128; H_kv 8 and 2; L 256
# and 8192; every lane at L-1); the gathered heads bitwise the world-1
# kernel's, within KERNEL_ATOL of the plain version's; H_kv 2 at model
# 4 is JAX's whole-head call; an off-by-one head offset must fail.
P14E_CASES = [(tp, kv, L, q8) for tp in (2, 4) for kv in (8, 2)
              for L in (256, 8192) for q8 in (False, True)]


# Phase 15, the in-graph pipeline: its runs a second wave after phase 12's
# (check_mesh), 15c/15d in 12d's world.
# 15a: pipe_lm at run_lm_bench's width (vocab 8192, d 1024, 8 heads of
# 128, T 2048, batch 8, M 4: microbatches of [2, 2048], bf16, Adam), 8
# blocks: --mesh_pipe 2 --model_depth 4 under gpipe and 1f1b, and
# --virtual_stages 2 --model_depth 2 under interleaved; 15b: pipe_vit at
# ViT-Tiny's width (CIFAR-100 synthetic, d 192, 3 heads, T 64: patch 4
# and no class token) at --mesh_pipe 2 --model_depth 6, batch 256, M 8,
# 1f1b, --augment crop_flip, --compute_dtype bfloat16, which rounds the
# input to bf16 and computes in fp32 as JAX's pipe_vit does (its Flax
# layers take no dtype: a bf16 input meets fp32 parameters and
# promotes), so its B1-B3 are the fp32 kernels. Each --spawn 2 --backend
# gloo, one epoch of 2 steps, then the evaluation.
P15A_ARGS = ["--model", "pipe_lm", "--dataset", "synthetic_seq",
             "--synthetic_size", "16", "--seq_len", "2048", "--vocab_size",
             "8192", "--model_dim", "1024", "--num_heads", "8",
             "--batch_size", "8", "--num_microbatches", "4", "--epochs", "1",
             "--optimizer", "adam", "--lr", "3e-4", "--compute_dtype",
             "bfloat16", "--mesh_pipe", "2", "--log_interval", "1"]
P15B_ARGS = (VIT_ARGS[:1] + ["pipe_vit"] + VIT_ARGS[2:]
             + ["--model_dim", "192", "--num_heads", "3", "--mesh_pipe",
                "2", "--model_depth", "6", "--num_microbatches", "8",
                "--pipe_schedule", "1f1b"])
P15B_ARGS[P15B_ARGS.index("--synthetic_size") + 1] = "512"
P15B_ARGS[P15B_ARGS.index("--epochs") + 1] = "1"
P15_RUNS = {
    "15a_pipe_gpipe": (P15A_ARGS, ["--model_depth", "2", "--pipe_schedule",
                                   "gpipe"], 2),
    "15a_pipe_1f1b": (P15A_ARGS, ["--model_depth", "4", "--pipe_schedule",
                                  "1f1b"], 2),
    "15a_pipe_interleaved": (P15A_ARGS, ["--model_depth", "1",
                                         "--pipe_schedule", "interleaved",
                                         "--virtual_stages", "2"], 2),
    "15b_pipe_vit": (P15B_ARGS, [], 2),
}
P12_RUNS.update(P15_RUNS)
# B1-B3 alone at 15a's microbatch: [2, 2048, 8, 128], causal.
P15A_SHAPE = ("15a pipe_lm microbatch T=S=2048 D 128", 2, 2048, 2048, 8, 128,
              True)
# 15a: the pipeline's eval loss against its checkpoint's to_dense_lm
# through CausalLM (bf16 both; the same products in another module).
P15_DENSE_ATOL = 1e-3
# 15c, in 12d's world: one fp32 step (SGD 0.1, B1-B3 in fp32) of pipe_lm
# at pipe 2 x data 2 under each schedule (interleaved: v 2) and at pipe 4
# with v 2, and of pipe_vit under 1f1b at pipe 2 x data 2, from the same
# seeded weights on the same global batch, against world 1's exact
# sequential step (the plain attention) within STEP_TOL["fp32"]; a 1F1B
# backward dropped at stage 0, the tied embedding without the head's
# part and interleaved chunks placed stage-major must fail it. Cuts: the
# LM at T 1024 (of 2048), one block a chunk, M 4 of one row each.
P15_LM = dict(vocab_size=8192, seq_len=1024, d_model=1024, num_heads=8,
              depth_per_stage=1, num_microbatches=4)
P15_VIT = dict(num_classes=100, patch_size=4, embed_dim=192, num_heads=3,
               depth_per_stage=1, num_microbatches=4, side=32, in_channels=3)
P15_CHECKS = {  # label: (family, pipe, virtual stages, schedule, control)
    "15c pipe_lm gpipe pipe 2 x data 2": ("lm", 2, 1, "gpipe", None),
    "15c pipe_lm 1f1b pipe 2 x data 2": ("lm", 2, 1, "1f1b", None),
    "15c pipe_lm 1f1b, a backward dropped at stage 0":
        ("lm", 2, 1, "1f1b", "dropped_backward"),
    "15c pipe_lm 1f1b, the tied embedding without the head's part":
        ("lm", 2, 1, "1f1b", "untied_head"),
    "15c pipe_lm interleaved v 2 pipe 2 x data 2":
        ("lm", 2, 2, "interleaved", None),
    "15c pipe_lm interleaved v 2 pipe 4": ("lm", 4, 2, "interleaved", None),
    "15c pipe_lm interleaved v 2 pipe 4, chunks stage-major":
        ("lm", 4, 2, "interleaved", "stage_major"),
    "15c pipe_vit 1f1b pipe 2 x data 2": ("vit", 2, 1, "1f1b", None),
}
# 15d, in 12d's world at pipe 2 x data 2 (P15_LM, fp32, microbatches of
# one row): stage 0's peak allocated memory over a step at M 4 and M 16;
# under 1f1b the M 16 peak is at most P15_MEMORY_RATIO x the M 4 one.
P15D_MICROBATCHES = (4, 16)
P15_MEMORY_RATIO = 1.1


# Phase 16, the pipe family's compositions: its 16a runs join phase 15's
# second wave, 16c runs in 12d's world. 16a, each --spawn 4 --backend gloo
# on the one card, one epoch of 2 steps, then the evaluation: pipe_lm at
# 15a's width (vocab 8192, d 1024, 8 heads of 128, T 2048, bf16, Adam;
# 8 blocks) at README's PP x TP command (--mesh_pipe 2 --mesh_model 2
# --model_depth 4 --pipe_schedule 1f1b --num_microbatches 8: microbatches
# of one row, B1-B3 on 4 heads a rank), at PP x SP (--mesh_seq 2, Ulysses,
# interleaved v 2, --model_depth 2) and at PP x EP (--mesh_expert 2
# --moe_experts 8 --moe_every 2, top-2, gpipe, --model_depth 4: 4 experts
# a rank; 32 sequences, the global batch 16 over 2 replicas); pipe_vit at
# 15b's width at --mesh_fsdp 2 --fast_epoch (1f1b; 128 images a replica,
# so 15b's microbatch halves).
P16_EP_ARGS = list(P15A_ARGS)
P16_EP_ARGS[P16_EP_ARGS.index("--synthetic_size") + 1] = "32"
P16_VIT_ARGS = list(P15B_ARGS)
P16_VIT_ARGS[P16_VIT_ARGS.index("--batch_size") + 1] = "128"
P16_RUNS = {
    "16a_pp_tp": (P15A_ARGS, ["--mesh_model", "2", "--model_depth", "4",
                              "--pipe_schedule", "1f1b",
                              "--num_microbatches", "8"], 4),
    "16a_pp_sp": (P15A_ARGS, ["--mesh_seq", "2", "--seq_strategy", "ulysses",
                              "--model_depth", "2", "--pipe_schedule",
                              "interleaved", "--virtual_stages", "2"], 4),
    "16a_pp_ep": (P16_EP_ARGS, ["--mesh_expert", "2", "--model_depth", "4",
                                "--moe_experts", "8", "--moe_every", "2",
                                "--pipe_schedule", "gpipe"], 4),
    "16a_vit_fsdp": (P16_VIT_ARGS, ["--mesh_fsdp", "2", "--fast_epoch"], 4),
}
P12_RUNS.update(P16_RUNS)
# Phase 15's second wave: its runs and 16a's.
PIPE_RUNS = {**P15_RUNS, **P16_RUNS}
# The q every B1-B3 launch of a 16a run takes ("BxTxHxD"), and its dtype.
P16_Q = {"16a_pp_tp": "1x2048x4x128", "16a_pp_sp": "2x2048x4x128",
         "16a_pp_ep": "2x2048x8x128", "16a_vit_fsdp": "16x64x3x64"}
# B1-B3 alone at 16a's PP x TP microbatch: [1, 2048, 4, 128], causal.
P16A_SHAPE = ("16a pipe_lm PP x TP microbatch T=S=2048 D 128", 1, 2048, 2048,
              4, 128, True)
# 16c, in 12d's world: one fp32 step (SGD 0.1, B1-B3 in fp32) of each
# composition from the same seeded weights on the same global batch (M 4
# microbatches of one row a data replica), against world 1's exact
# sequential step (the plain attention) within STEP_TOL["fp32"]: pipe_lm
# (P15_LM: d 1024, T 1024, one block a chunk) at pipe 2 x fsdp 2, pipe 2 x
# model 2, pipe 2 x expert 2 (every block routed over 4 experts, top-2, at
# the capacity factor E/k = 2.0 that drops nothing: the drops are counted
# and must be 0) and pipe 2 x seq 2 (Ulysses, and the causal ring hops of
# [1, 512, 8, 128] under gpipe); pipe_vit at pipe 2 x model 2 (d 192, 2
# heads of 96: P15_VIT's 3 heads do not split over 2) and pipe 2 x fsdp 2.
# A control an axis must fail.
P16_CHECKS = {  # label: (family, axes, virtual, schedule, config, control)
    "16c pipe_lm gpipe pipe 2 x fsdp 2":
        ("lm", dict(pipe=2, fsdp=2), 1, "gpipe", {}, None),
    "16c pipe_lm 1f1b pipe 2 x fsdp 2":
        ("lm", dict(pipe=2, fsdp=2), 1, "1f1b", {}, None),
    "16c pipe_lm 1f1b pipe 2 x fsdp 2, a stage gradient scattered unsummed":
        ("lm", dict(pipe=2, fsdp=2), 1, "1f1b", {}, "fsdp_unsummed"),
    "16c pipe_lm 1f1b pipe 2 x model 2":
        ("lm", dict(pipe=2, model=2), 1, "1f1b", dict(tp_size=2), None),
    "16c pipe_lm interleaved v 2 pipe 2 x model 2":
        ("lm", dict(pipe=2, model=2), 2, "interleaved", dict(tp_size=2),
         None),
    "16c pipe_lm 1f1b pipe 2 x model 2, the rebuilt chunk's f unsummed":
        ("lm", dict(pipe=2, model=2), 1, "1f1b", dict(tp_size=2),
         "unsummed_f"),
    "16c pipe_lm gpipe pipe 2 x expert 2":
        ("lm", dict(pipe=2, expert=2), 1, "gpipe",
         dict(num_experts=4, moe_every=1, ep_size=2), None),
    "16c pipe_lm 1f1b pipe 2 x expert 2":
        ("lm", dict(pipe=2, expert=2), 1, "1f1b",
         dict(num_experts=4, moe_every=1, ep_size=2), None),
    "16c pipe_lm 1f1b pipe 2 x expert 2, an expert leaf summed over expert":
        ("lm", dict(pipe=2, expert=2), 1, "1f1b",
         dict(num_experts=4, moe_every=1, ep_size=2), "expert_summed"),
    "16c pipe_lm 1f1b pipe 2 x seq 2 ulysses":
        ("lm", dict(pipe=2, seq=2), 1, "1f1b",
         dict(sp_size=2, sp_strategy="ulysses"), None),
    "16c pipe_lm gpipe pipe 2 x seq 2 ring":
        ("lm", dict(pipe=2, seq=2), 1, "gpipe",
         dict(sp_size=2, sp_strategy="ring"), None),
    "16c pipe_lm 1f1b pipe 2 x seq 2 ulysses, stage 0 without the offset":
        ("lm", dict(pipe=2, seq=2), 1, "1f1b",
         dict(sp_size=2, sp_strategy="ulysses"), "no_pos_offset"),
    "16c pipe_vit 1f1b pipe 2 x model 2":
        ("vit", dict(pipe=2, model=2), 1, "1f1b",
         dict(num_heads=2, tp_size=2), None),
    "16c pipe_vit 1f1b pipe 2 x fsdp 2":
        ("vit", dict(pipe=2, fsdp=2), 1, "1f1b", {}, None),
}


def _p14_model(torch, family, cfgs):
    """(the model with its seeded full state loaded, on the CPU, the
    state) of a 14d family."""
    from ddp_tpu_torch.models import get_model

    name, kw = {"vit14": ("vit_tiny", dict(num_classes=100, side=32,
                                           in_channels=3, depth=2)),
                "moe14": ("vit_moe_tiny", dict(
                    num_classes=100, side=32, in_channels=3, depth=2,
                    capacity_factor=cfgs["moe_cf"])),
                "rn14": ("resnet18", dict(num_classes=10, side=32,
                                          in_channels=3)),
                "cnn14": ("simple_cnn", dict(num_classes=10, side=28,
                                             in_channels=1))}[family]
    model = get_model(name, **kw)
    state = model.init_state(seed=14)
    if family == "rn14":
        state = _live_bn_scales(state)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model, state


def _p14_batch(torch, family, dev):
    rng = np.random.default_rng(140)
    side, ch, classes = {"cnn14": (28, 1, 10), "rn14": (32, 3, 10)}.get(
        family, (32, 3, 100))
    x = rng.integers(0, 256, (P14_ROWS, side, side, ch), dtype=np.uint8)
    y = rng.integers(0, classes, P14_ROWS)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _p14_controls(torch, control):
    """(owner, name, value) patches of a 14d control; the model patches
    (applied after the model takes its GSPMD form) separately."""
    from ddp_tpu_torch.parallel import seq_fsdp
    from ddp_tpu_torch.train.optim import Zero1Optimizer

    if control == "drop_scale":
        return ((seq_fsdp, "FAULT", control),)
    if control == "skip_gather":
        return ((Zero1Optimizer, "FAULT", control),)
    return ()


def _p14_local(model, control) -> None:
    """A model-level 14d control: BatchNorm by the rank's own moments, or
    MoE routing over the rank's own tokens."""
    from ddp_tpu_torch.models.moe import MoEMLP
    from ddp_tpu_torch.models.resnet import BatchNorm
    from ddp_tpu_torch.runtime.dist import LocalComm

    for m in model.modules():
        if control == "local_bn" and isinstance(m, BatchNorm):
            m.sync = LocalComm()
        if control == "local_routing" and isinstance(m, MoEMLP):
            m.spmd.data = LocalComm()


def _p14d_step(torch, label, mesh, dev, cfgs, masks, routes) -> tuple:
    """One 14d mesh step on this rank → (loss, full gradients, full
    parameters after the update), on the CPU; records the ResNet's ReLU
    masks and the MoE's routing of the uncontrolled runs."""
    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.models import resnet
    from ddp_tpu_torch.parallel import spmd
    from ddp_tpu_torch.parallel.ddp import TrainState
    from ddp_tpu_torch.train.optim import make_optimizer

    family, _, zero1, control = P14_CHECKS[label]
    model, _ = _p14_model(torch, family, cfgs)
    layout = spmd.shard_model(model, mesh, zero1=zero1)
    _p14_local(model, control)
    model = model.to(dev)
    opt = make_optimizer(model.parameters(), "sgd", lr=0.1,
                         zero1_layout=layout if zero1 else None)
    opt.norm = layout.norm
    x, y = _p14_batch(torch, family, dev)
    per = P14_ROWS // mesh.data_size
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    tied = _TiedRelu(resnet.F)
    real_route = tmoe.route_global

    def route(*a, **kw):
        r = real_route(*a, **kw)
        if control is None:
            routes.append((label, mesh.data_rank, r._replace(
                expert=r.expert.cpu(), slot=r.slot.cpu(), kept=r.kept.cpu(),
                gates=r.gates.cpu(), aux=r.aux.cpu())))
        return r

    patches = [(tmoe, "route_global", route)]
    if family == "rn14":
        patches.append((resnet, "F", tied))
    with _patched(*patches, *_p14_controls(torch, control)):
        m = spmd.make_spmd_train_step(TrainState(0, model, opt), mesh)(
            x[rows], y[rows])
        named = dict(model.named_parameters())
        grads = layout.gather({n: p.grad for n, p in named.items()})
        params = layout.gather({n: p.detach() for n, p in named.items()})
    if family == "rn14" and control is None:
        masks[label] = (mesh.data_rank, tied.masks)
    return (float(m.loss), {k: v.detach().cpu() for k, v in grads.items()},
            {k: v.detach().cpu() for k, v in params.items()})


def _p14e_checks(torch, mesh_of, dev) -> dict:
    """14e on this rank of 12d's world (``mesh_of(axes)``: its mesh of
    those axes): each P14E_CASES shard call's launches, and whether its
    gathered heads equal the world-1 kernel's bits, the plain version's
    within KERNEL_ATOL, and (the control) part from them under an
    off-by-one head offset."""
    from ddp_tpu_torch.ops import decode as dec

    out = {}
    meshes = {tp: mesh_of(dict(model=tp)) for tp in (2, 4)}
    S, H, Dh = 8, 8, 128
    for tp, kv, L, q8 in P14E_CASES:
        # Drawn on the device: the wave's processes share the host's cores.
        g = torch.Generator(device=dev).manual_seed(14 + kv + L)
        q, k, v = (torch.randn(shape, generator=g, device=dev) for shape in
                   ((S, H, Dh), (S, L, kv, Dh), (S, L, kv, Dh)))
        scales = (None, None)
        if q8:
            (k, ks), (v, vs) = dec.quantize_kv(k), dec.quantize_kv(v)
            scales = (ks, vs)
        pos = torch.full((S,), L - 1, dtype=torch.int32, device=dev)
        whole = dec.flash_decode_attention(q, k, v, pos, *scales)
        plain = dec.decode_attention_reference(q, k, v, pos, *scales)
        fn = dec.shard_decode_attention(meshes[tp], impl="flash")
        before = dict(dec.flash_decode_attention.launches)
        w0 = dec.shard_decode_attention.whole
        got = fn(q, k, v, pos, *scales)
        torch.cuda.synchronize()
        launched = {n: dec.flash_decode_attention.launches[n] - before[n]
                    for n in before}
        whole_calls = dec.shard_decode_attention.whole - w0
        dec.SHARD_FAULT = "offset"
        try:
            bad = fn(q, k, v, pos, *scales)
        finally:
            dec.SHARD_FAULT = None
        out[(tp, kv, L, q8)] = dict(
            launches=sum(launched.values()),
            whole=whole_calls,
            bitwise=bool(torch.equal(got, whole)),
            plain_err=float((got - plain).abs().max()),
            control_err=float((bad - whole).abs().max()))
        del k, v, whole, plain, got, bad
    return out


def _replayed_global(torch, olds, tokens, router_weight, router_bias,
                     num_experts, normalize_gates, capacity_factor):
    """The mesh's global routing (``olds``: each data replica's, in its
    rank order) on world 1's ``tokens`` (all of them): the experts and
    kept assignments concatenated, the slots numbered in the global
    k-major order, the gates and aux loss recomputed from this router."""
    from ddp_tpu_torch.models import moe as tmoe

    expert = torch.cat([o.expert for _, o in olds], 1).to(tokens.device)
    kept = torch.cat([o.kept for _, o in olds], 1).to(tokens.device)
    K, n = expert.shape
    masks = (expert[..., None] == torch.arange(
        num_experts, device=tokens.device)).float()
    flat = masks.reshape(K * n, num_experts)
    pos = (flat.cumsum(0) - flat).reshape(K, n, num_experts)
    slot = (pos * masks * kept[..., None]).sum(-1).long()
    C = tmoe.expert_capacity(n, num_experts, K, capacity_factor)
    old = tmoe.Routing(expert, slot, kept, None, None, C)
    return _replayed(torch, old, tokens, router_weight, router_bias,
                     num_experts, normalize_gates)


def _p14d_reference(torch, label, dev, cfgs, masks, routes) -> tuple:
    """World 1's exact fp32 step (SGD 0.1, the plain attention) of a 14d
    label's family on the global batch → (loss, gradients, updated
    parameters), with the mesh's routing or ReLU masks held."""
    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.models import resnet
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
    from ddp_tpu_torch.train.optim import make_optimizer

    family = P14_CHECKS[label][0]
    model, _ = _p14_model(torch, family, cfgs)
    model = model.to(dev)
    for name in getattr(model, "block_names", ()):
        block = getattr(model, name)
        if hasattr(block, "attn"):
            block.attn.attention_fn = \
                lambda q, k, v: fl.attention_with_lse_reference(q, k, v,
                                                                False)[0]
    patches, tied = [], None
    if family == "rn14":
        ranks = sorted(masks[label][1], key=lambda p: p[0])
        tied = _TiedRelu(resnet.F, [torch.cat(parts, 0) for parts in
                                    zip(*(m for _, m in ranks))])
        patches.append((resnet, "F", tied))
    if family == "moe14":
        # Each data replica's routings in call order, replica-major: call
        # i's global routing is every replica's i-th.
        mine = sorted(((r, o) for lab, r, o in routes if lab == label),
                      key=lambda p: p[0])
        ncalls = len(mine) // len({r for r, _ in mine})
        it = iter([mine[i::ncalls] for i in range(ncalls)])

        def held(tokens, router_weight, router_bias, *, num_experts, top_k,
                 capacity_factor, normalize_gates):
            return _replayed_global(torch, next(it), tokens, router_weight,
                                    router_bias, num_experts,
                                    normalize_gates, capacity_factor)

        patches.append((tmoe, "route", held))
    opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
    with _patched(*patches):
        m = make_train_step(TrainState(0, model, opt),
                            reduce=lambda t: t)(*_p14_batch(torch, family,
                                                            dev))
    named = dict(model.named_parameters())
    out = (float(m.loss), {n: p.grad.detach().cpu() for n, p in named.items()},
           {n: p.detach().cpu() for n, p in named.items()})
    return out, (tied.flips if tied else None)


def _lm_cfg(cfgs, family) -> dict:
    """The LMSpec fields of a 12d/13c LM family."""
    base = _p13_base(family)
    return cfgs["moe" if base == "moe" else "lm13" if base in ("lm2", "lm4")
                else "lm"]


def _p13_base(family) -> str:
    """A 12d family's inputs and reference: "lm", "lc", "moe" (12d's);
    "lm2", "lm4" (13c's LM, P13_LM, 2 and 4 rows), "vit" (the zero and
    gather variants share their base's)."""
    return family.removesuffix("_bf16").removesuffix("_zero")


def _rank_trace(path) -> dict:
    """A rank's ``--profile_dir`` trace → its B1-B3 kernel launches in
    training (before the last ``train_step`` span ends) and in all, its
    step p50 (the host spans, ms: with the exchanges staged through the
    host a step's span waits for its device work) and its busy share
    (the union of its kernels over the steps' window), both without the
    first step, the warm-up, where a run took more than one."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("name") == "train_step" and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                     for e in events if e.get("cat") == "kernel")
    timed = spans[1:] or spans
    lo, hi = timed[0][0], spans[-1][1]
    busy, reach = 0.0, lo
    for a, b, _ in kernels:
        a, b = max(a, reach, lo), min(b, hi)
        if b > a:
            busy += b - a
            reach = b
    count = {key: 0 for key in FLASH_KERNELS}
    train = dict(count)
    for a, _, name in kernels:
        for key, k in FLASH_KERNELS.items():
            if re.search(rf"\b{k}\b", name):
                count[key] += 1
                train[key] += a < hi
    return dict(train=train, total=count,
                step_p50_ms=float(np.median([b - a for a, b in timed])) / 1e3,
                busy=busy / (hi - lo), steps=len(spans), timed=len(timed))


def _p12_expected(name, depth, steps, rank) -> int:
    """B1 = B2 = B3 launches of a rank in training: a ring hop is one
    block call, so the non-causal ring (12a) runs 4 a layer, the causal
    one (12b) seq rank + 1 (the future hops skip); Ulysses, TP and EP
    one a layer."""
    if name == "12a_ring":
        return depth * steps * 4
    if name == "12b_seq2":
        return depth * steps * (rank + 1)
    if name == "12b_model2_seq2":  # rank = seq · 2 + model
        return depth * steps * (rank // 2 + 1)
    if name == "13a_fsdp2_seq2":  # rank = fsdp · 2 + seq
        return depth * steps * (rank % 2 + 1)
    if name.startswith("14c"):  # ResNet: no attention
        return 0
    return depth * steps


# 15b's kernels: fp32 (the Flax promotion JAX's pipe_vit keeps), none bf16.
P15_DTYPE = {"15b_pipe_vit": ("fp32", "bf16"),
             "16a_vit_fsdp": ("fp32", "bf16")}


def _p15_dtype(run) -> str:
    """The dtype of a phase-12 wave run's B1-B3 launches."""
    return P15_DTYPE.get(run, ("bf16",))[0]


def _flag(args, name, default):
    """The value of flag ``name`` in ``args`` (its last, as argparse
    takes it), or ``default``."""
    at = [i for i, a in enumerate(args) if a == name]
    return args[at[-1] + 1] if at else default


def _p15_expected(args, steps) -> dict:
    """A pipe rank's B1-B3 launches in training from its timetable: each
    of the M microbatches through each of its v chunks of ``depth``
    blocks forward and backward a step (B2, B3 once a block), B1 twice
    under the hand-scheduled schedules (the backward slot rebuilds the
    chunk)."""
    M = int(_flag(args, "--num_microbatches", 4))
    V = int(_flag(args, "--virtual_stages", 1))
    n = steps * M * V * int(_flag(args, "--model_depth", 1))
    twice = _flag(args, "--pipe_schedule", "gpipe") != "gpipe"
    return {"flash_attn_fwd": n * (2 if twice else 1), "flash_attn_dq": n,
            "flash_attn_dkv": n}


def _hop_launches(run, key, causal) -> int:
    """A ring run's training launches of ``key`` at its past hops' shape:
    every rank's under a non-causal ring (hop 0 is one more unmasked
    block); under a causal one rank r's r past hops of its r + 1 live
    ones (hop 0, the causal diagonal block, is other work)."""
    return sum(rk["train"][key] * r // (r + 1) if causal else rk["train"][key]
               for r, rk in enumerate(run["ranks"]))


def _p12_argv(name, tmp) -> list:
    base, extra, world = P12_RUNS[name]
    return (base + CNN_DEVICE_ARGS + extra + GLOO + [
        "--spawn", str(world), "--profile_dir", f"{tmp}/{name}_prof",
        "--checkpoint_dir", f"{tmp}/{name}",
        "--metrics_file", f"{tmp}/{name}.jsonl"])


def _p12_breakdown(tmp, name, span) -> dict:
    """Where a run's wall time went (``span``: the start and end of the
    runs, host clock), from rank 0's ``--metrics_file`` records (s):
    ``start`` to ``run_start`` (the processes, the mesh, the data and
    the model), ``train`` to the ``epoch`` record (the steps and the
    epoch's host read), ``after`` to ``final`` (the evaluation and the
    checkpoint), ``tail`` to the runs' end (the traces, the teardown,
    the slower runs)."""
    with open(f"{tmp}/{name}.jsonl") as f:
        at = {r["kind"]: r["time"] for r in map(json.loads, f)}
    return dict(start=at["run_start"] - span[0],
                train=at["epoch"] - at["run_start"],
                after=at["final"] - at["epoch"], tail=span[1] - at["final"])


def _p12_readings(torch, tmp, name, code, lines, span) -> tuple[dict, list]:
    """One phase-12 run's per-rank readings from its traces, and its
    wall time's breakdown (``span``: the runs' start and end, host
    clock) → (readings, failures)."""
    import os

    base, _, world = P12_RUNS[name]
    if code != 0:
        first = next((i for i, ln in enumerate(lines) if "Traceback" in ln),
                     max(0, len(lines) - 20))
        log(f"[mesh] {name} exited {code}; its output from the first "
            "traceback:\n" + "\n".join(lines[first:first + 80]))
        return {}, [f"{name}: exit {code}: {lines[-20:]}"]
    args = base + P12_RUNS[name][1]
    depth = int(_flag(args, "--model_depth", 2))
    steps = int(torch.load(f"{tmp}/{name}/epoch_0/state.pt",
                           weights_only=True)["step"])
    dt, other = P15_DTYPE.get(name, ("bf16", "fp32"))
    ranks, failed = [], []
    for r in range(world):
        path = f"{tmp}/{name}_prof/trace_rank{r}.json"
        if not os.path.exists(path):
            failed.append(f"{name}: rank {r} wrote no trace")
            continue
        t = _rank_trace(path)
        want = (_p15_expected(args, steps) if name in PIPE_RUNS else
                dict.fromkeys(FLASH_NAMES,
                              _p12_expected(name, depth, steps, r)))
        if not (all(t["train"][f"{n}_{dt}"] == want[n] for n in FLASH_NAMES)
                and not any(t["total"][f"{n}_{other}"] for n in FLASH_NAMES)):
            failed.append(f"{name}: rank {r} launched {t['train']} in "
                          f"training, not B1, B2, B3 = "
                          f"{[want[n] for n in FLASH_NAMES]} in {dt}")
        ranks.append(dict(t, want=want))
        log(f"[mesh] {name} rank {r}/{world}: step p50 "
            f"{t['step_p50_ms']:.3f} ms over {t['timed']} of its {t['steps']} "
            f"steps (the warm-up left out), busy share "
            f"{t['busy']:.3f}, B1-B3 in training "
            f"{[t['train'][f'{n}_{dt}'] for n in FLASH_NAMES]} (want "
            f"{[want[n] for n in FLASH_NAMES]}), in all "
            f"{[t['total'][f'{n}_{dt}'] for n in FLASH_NAMES]}")
    text = [ln for ln in lines if ln.startswith(("epoch 1/", "Epoch 0 done",
                                                 "final_accuracy="))]
    parts = _p12_breakdown(tmp, name, span)
    log(f"[mesh] {name}: {world} processes on one card through gloo, "
        f"{steps} steps, depth {depth}; of the runs' {span[1] - span[0]:.1f} "
        f"s (all at once): start-up {parts['start']:.1f}, training "
        f"{parts['train']:.1f}, eval and checkpoint {parts['after']:.1f}, "
        f"then to the runs' end {parts['tail']:.1f} s: {text}")
    return dict(world=world, depth=depth, steps=steps,
                seconds=span[1] - span[0], wall=parts, ranks=ranks), failed


def _p12_cfgs() -> dict:
    """12d's model configurations by family (passed to the spawned
    ranks, so that a rehearsal's cut sizes reach them)."""
    return dict(lc=dict(P12_LC), lm=dict(P12_LM), moe=dict(P12_MOE),
                lm13=dict(P13_LM), vit=dict(P13_VIT), clip=P13_CLIP,
                moe_cf=P14_MOE_CF, p15_lm=dict(P15_LM),
                p15_vit=dict(P15_VIT), p16=dict(P16_CHECKS))


def _p12d_models(torch, family, state, dev, cfgs):
    """(a function building the model from the FULL state on a mesh, a
    step maker) of a 12d family."""
    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import seq_transformer as tst
    from ddp_tpu_torch.parallel.ddp import TrainState
    from ddp_tpu_torch.parallel.tp import shard_module

    if family.startswith("lc"):
        spec = tst.SeqTransformerSpec(
            **cfgs["lc"], strategy="ulysses" if family == "lc_ulysses" else
            "ring")
        return (lambda mesh: tst.build_model(spec, state, dev, mesh=mesh),
                lambda model, opt, mesh: tst.make_seq_parallel_train_step(
                    TrainState(0, model, opt), mesh))
    if family.startswith("vit"):
        from ddp_tpu_torch.models import get_model
        from ddp_tpu_torch.parallel.zero import make_zero_train_step

        def build_vit(mesh):
            model = get_model("vit_tiny", **cfgs["vit"])
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in state.items()})
            return model.to(dev)

        return build_vit, lambda model, opt, mesh: make_zero_train_step(
            TrainState(0, model, opt), mesh.comm("data"))
    spec = tlm.LMSpec(**_lm_cfg(cfgs, family))

    def build(mesh):
        model = tlm.CausalLM.from_state(spec, state, "cpu", trainable=True)
        shard_module(model, mesh)
        return model.to(dev)

    return build, lambda model, opt, mesh: tlm.make_lm_train_step(
        model, opt, mesh=mesh)


def _p12d_inputs(torch, family, dev, cfgs):
    """12d's seeded full state and global batch of a family."""
    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import seq_transformer as tst

    family = _p13_base(family)
    if family == "vit":
        from ddp_tpu_torch.models import get_model

        rng = np.random.default_rng(13)
        state = get_model("vit_tiny", **cfgs["vit"]).init_state(seed=13)
        x = rng.integers(0, 256, (P12_WORLD, 32, 32, 3), dtype=np.uint8)
        y = rng.integers(0, cfgs["vit"]["num_classes"], P12_WORLD)
        return state, (torch.from_numpy(x).to(dev),
                       torch.from_numpy(y).to(dev))
    rng = np.random.default_rng(12 if family != "lm4" else 14)
    if family.startswith("lc"):
        lc = cfgs["lc"]
        state = tst.init_seq_transformer(tst.SeqTransformerSpec(**lc),
                                         seed=12)
        x = rng.standard_normal((2, lc["total_len"], lc["d_in"]))
        y = rng.integers(0, lc["num_classes"], 2)
        return state, (torch.from_numpy(x.astype(np.float32)).to(dev),
                       torch.from_numpy(y).to(dev))
    cfg = _lm_cfg(cfgs, family)
    state = tlm.init_lm_state(tlm.LMSpec(**cfg), seed=12)
    toks = rng.integers(0, cfg["vocab_size"],
                        (P12_WORLD if family in ("moe", "lm4") else 2,
                         cfg["total_len"]))
    return state, (torch.from_numpy(toks).to(dev),)


def _p12d_controls(torch, control):
    """The (owner, name, value) patches of a 12d control."""
    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.parallel import ring

    if control == "drop_hop":
        real, calls = ring.default_block_fn, [0]

        def dropped(q, k, v, causal):
            calls[0] += 1
            o, lse = real(q, k, v, causal)
            if calls[0] % 4 == 2:  # hop 1 of each ring call (n 4)
                return torch.zeros_like(o), torch.full_like(lse,
                                                            -float("inf"))
            return o, lse
        return ((ring, "default_block_fn", dropped),)
    if control == "double":
        real = tlm._reduce_gradients

        def doubled(params, names, layout, mesh, extras):
            rest = real(params, names, layout, mesh, extras)
            for n, p in zip(names, params):
                if n not in layout.specs:
                    mesh.comm("model").all_reduce_(p.grad)
            return rest
        return ((tlm, "_reduce_gradients", doubled),)
    if control == "drop_scale":
        from ddp_tpu_torch.parallel import seq_fsdp
        return ((seq_fsdp, "FAULT", control),)
    if control in ("clip_model", "offset"):
        from ddp_tpu_torch.parallel import zero
        return ((zero, "FAULT", control),)
    if control == "misroute":
        real = tmoe.all_to_all

        def wrong_owner(t, comm, split_dim, concat_dim):
            shift = t.shape[split_dim] // comm.size
            return real(torch.roll(t, shift, split_dim), comm, split_dim,
                        concat_dim)
        return ((tmoe, "all_to_all", wrong_owner),)
    return ()


def _p12d_worker(rank, world, out, device, cfgs):
    """One rank of 12d's gloo world: the fp32 step of every P12_CHECKS
    mesh from the seeded weights on its data replica's rows; rank 0
    saves the losses and the gathered gradients, every rank of the
    routed mesh its routing."""
    import torch

    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.parallel.zero import ZeroOptimizer
    from ddp_tpu_torch.runtime import dist
    from ddp_tpu_torch.runtime.mesh import dist_mesh, mesh_sizes
    from ddp_tpu_torch.train.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = dist.setup(rank, world, backend="gloo", device=device)
    results, routes, states = {}, [], {}
    try:
        # C7: does this torch's gloo take reduce_scatter_tensor? (The
        # port's gloo reduce-scatter is written from all_to_all either
        # way: runtime/dist.DistComm.reduce_scatter.)
        import torch.distributed as tdist

        rs = torch.empty(2)
        try:
            tdist.reduce_scatter_tensor(rs, torch.arange(2.0 * world))
            results["gloo_reduce_scatter_tensor"] = f"takes it: {rs.tolist()}"
        except Exception as e:  # noqa: BLE001 — the reading
            results["gloo_reduce_scatter_tensor"] = \
                f"refuses it: {type(e).__name__}: {str(e)[:160]}"
        inputs, meshes = {}, {}

        def mesh_of(axes):
            # One mesh (and its process groups) a set of axes: every rank
            # makes them in the same order, as new_group requires.
            key = tuple(sorted(axes.items()))
            if key not in meshes:
                meshes[key] = dist_mesh(mesh_sizes(world, **axes), rank)
            return meshes[key]

        for label, (family, axes, control) in P12_CHECKS.items():
            base = _p13_base(family)
            if base not in inputs:
                inputs[base] = _p12d_inputs(torch, base, ctx.device, cfgs)
            state, batch = inputs[base]
            mesh = mesh_of(axes)
            build, step_of = _p12d_models(torch, family, state, ctx.device,
                                          cfgs)
            model = build(mesh)
            layout = getattr(model, "shard_layout", None)
            if family.endswith(("_zero", "_bf16")):
                opt = ZeroOptimizer(
                    model.named_parameters(), mesh.comm("data"), name="sgd",
                    lr=0.1, grad_clip_norm=cfgs["clip"] if base != "vit"
                    else 0.0,
                    gather_dtype="bf16" if family.endswith("_bf16")
                    else "fp32",
                    model_comm=mesh.comm("model"),
                    model_names={n for n in (layout.specs if layout else ())
                                 if "model" in layout.axes(n)})
            else:
                opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
                opt.norm = layout.norm
            per = batch[0].shape[0] // mesh.data_size
            rows = [b[mesh.data_rank * per:][:per] for b in batch]
            real_route = tmoe.route

            def route(*a, **kw):
                r = real_route(*a, **kw)
                if family == "moe" and control is None:
                    routes.append((mesh.data_rank, r._replace(
                        expert=r.expert.cpu(), slot=r.slot.cpu(),
                        kept=r.kept.cpu(), gates=r.gates.cpu(),
                        aux=r.aux.cpu())))
                return r

            with _patched((tmoe, "route", route),
                          *_p12d_controls(torch, control)):
                m = step_of(model, opt, mesh)(*rows)
                if isinstance(opt, ZeroOptimizer):
                    grads = opt.last_grads()  # the update's, clipped
                    if layout is not None:
                        grads = layout.gather(grads)
                    if base == "vit":  # the parameters the update gave
                        full = (opt.state_dict()["master"] if opt.master_mode
                                else [p.detach().cpu() for p in opt.params])
                        states[label] = dict(zip(opt.names, full))
                else:
                    grads = layout.gather(
                        {n: p.grad for n, p in model.named_parameters()})
            results[label] = (float(m.loss),
                              {k: v.detach().cpu() for k, v in grads.items()})
            del model, opt, grads
            if torch.cuda.is_available():  # the wave beside shares the card
                torch.cuda.empty_cache()
        torch.save(routes, f"{out}/12d_routes{rank}.pt")
        p14_masks, p14_routes = {}, []
        for label, (_, axes, _, _) in P14_CHECKS.items():
            mesh = mesh_of(axes)
            results[label] = _p14d_step(torch, label, mesh, ctx.device, cfgs,
                                        p14_masks, p14_routes)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        p14e = _p14e_checks(torch, mesh_of, ctx.device)
        torch.save((p14_masks, p14_routes, p14e), f"{out}/14d_rank{rank}.pt")
        if rank == 0:
            results["13c_states"] = states
            torch.save(results, f"{out}/12d_steps.pt")
        p15 = _p15_worker_steps(torch, mesh_of, ctx.device, cfgs, rank)
        if rank == 0:
            torch.save(p15, f"{out}/15_steps.pt")
        p16 = _p16_worker_steps(torch, mesh_of, ctx.device, cfgs)
        if rank == 0:
            torch.save(p16, f"{out}/16_steps.pt")
    finally:
        dist.cleanup()


def _p12d_reference(torch, family, dev, cfgs, routes=None):
    """World 1's exact step (fp32, the plain attention) of a family from
    the same weights → (loss, {name: gradient}); the routed LM's is the
    mean over the data replicas of world 1 on each replica's rows, each
    replaying that replica's routing from the mesh step (C12)."""
    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.models import seq_transformer as tst
    from ddp_tpu_torch.parallel import ring
    from ddp_tpu_torch.parallel.ddp import TrainState
    from ddp_tpu_torch.runtime.mesh import local_mesh
    from ddp_tpu_torch.train.optim import make_optimizer

    state, batch = _p12d_inputs(torch, family, dev, cfgs)
    plain = ring._xla_block_with_lse
    if family == "vit":
        from ddp_tpu_torch.models import get_model
        from ddp_tpu_torch.ops import flash as fl
        from ddp_tpu_torch.parallel.ddp import make_train_step

        model = get_model("vit_tiny", **cfgs["vit"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        model = model.to(dev)
        for name in model.block_names:
            getattr(model, name).attn.attention_fn = \
                lambda q, k, v: fl.attention_with_lse_reference(
                    q, k, v, False)[0]
        st = TrainState(0, model, make_optimizer(model.parameters(), "sgd",
                                                 lr=0.1))
        m = make_train_step(st, reduce=lambda t: t)(*batch)
        named = dict(model.named_parameters())
        return (float(m.loss), {n: p.grad.detach().cpu()
                                for n, p in named.items()},
                {n: p.detach().cpu() for n, p in named.items()})
    if family.startswith("lc"):
        one = local_mesh()
        model = tst.build_model(tst.SeqTransformerSpec(**cfgs["lc"]), state,
                                dev,
                                attention_fn=lambda q, k, v:
                                plain(q, k, v, False)[0], mesh=one)
        st = TrainState(0, model, make_optimizer(model.parameters(), "sgd",
                                                 lr=0.1))
        m = tst.make_seq_parallel_train_step(st, one)(*batch)
        return float(m.loss), {n: p.grad.detach().cpu()
                               for n, p in model.named_parameters()}
    spec = tlm.LMSpec(**_lm_cfg(cfgs, family))

    def step(rows):
        model = tlm.CausalLM.from_state(spec, state, dev, trainable=True)
        opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
        m = tlm.make_lm_train_step(model, opt, block_fn=plain)(rows)
        return float(m.loss), {n: p.grad.detach().cpu()
                               for n, p in model.named_parameters()}

    if family == "lm4":  # the mean of two world-1 steps of 2 rows
        parts = [step(batch[0][i:i + 2]) for i in (0, 2)]
        return (sum(p[0] for p in parts) / 2,
                {k: (parts[0][1][k] + parts[1][1][k]) / 2
                 for k in parts[0][1]})
    if family != "moe":
        return step(batch[0])
    parts = []
    for replica, old in routes:
        def held(tokens, router_weight, router_bias, *, num_experts, top_k,
                 capacity_factor, normalize_gates, old=old):
            return _replayed(torch, old, tokens, router_weight, router_bias,
                             num_experts, normalize_gates)

        with _patched((tmoe, "route", held)):
            parts.append(step(batch[0][replica:replica + 1]))
    n = len(parts)
    return (sum(p[0] for p in parts) / n,
            {k: sum(p[1][k] for p in parts) / n for k in parts[0][1]})


def start_mesh_steps(tmp, dev="cuda"):
    """Start 12d's gloo world of P12_WORLD processes on the card (its
    ranks run the fp32 step of every P12_CHECKS mesh) → its context,
    joined by :func:`check_mesh_steps`."""
    import os

    import torch.multiprocessing as mp

    from ddp_tpu_torch.runtime import dist

    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(dist.free_port())
    return mp.start_processes(_p12d_worker,
                              args=(P12_WORLD, tmp, dev, _p12_cfgs()),
                              nprocs=P12_WORLD, join=False,
                              start_method="spawn")


def _join_world(world, started) -> str | None:
    """Join 12d's world (:func:`start_mesh_steps`; ``started`` its start,
    ``time.perf_counter``) until P12D_DEADLINE s from its start → None
    when every rank finished, else why not (a hung world's processes are
    killed)."""
    from torch.multiprocessing import (
        ProcessExitedException,
        ProcessRaisedException,
    )

    try:
        while not world.join(timeout=max(
                0.0, started + P12D_DEADLINE - time.perf_counter())):
            if time.perf_counter() >= started + P12D_DEADLINE:
                for proc in world.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
                return f"hung past {P12D_DEADLINE} s"
    except (ProcessExitedException, ProcessRaisedException) as e:
        return f"{type(e).__name__}: {e}"  # join killed the other ranks
    return None


def check_mesh_steps(torch, tmp, world, started,
                     dev="cuda") -> tuple[dict, list]:
    """12d: every P12_CHECKS mesh's fp32 step (B1-B3 in fp32) from
    ``world`` (:func:`start_mesh_steps` at ``started``, joined here
    against P12D_DEADLINE), against world 1's exact step, held to
    STEP_TOL["fp32"]; each control (a dropped past hop, the model
    reduction counted twice, slots sent to the wrong owner) must fail it.
    A world that failed or hung fails every check."""
    t0 = time.perf_counter()
    fault = _join_world(world, started)
    log(f"[mesh] 12d: waited {time.perf_counter() - t0:.1f} s more for "
        f"the {P12_WORLD}-process world's steps"
        + (f"; it failed: {fault}" if fault else ""))
    if fault:
        return {}, [f"12d: {fault}"]
    got = torch.load(f"{tmp}/12d_steps.pt", weights_only=False)
    cfgs = _p12_cfgs()
    routes = sorted(
        (pair for rank in range(P12_WORLD)
         for pair in torch.load(f"{tmp}/12d_routes{rank}.pt",
                                weights_only=False)), key=lambda p: p[0])
    tol = STEP_TOL["fp32"]
    readings, failed, refs = {}, [], {}
    log(f"[mesh] 13c: gloo's reduce_scatter_tensor on this torch "
        f"{torch.__version__}: {got['gloo_reduce_scatter_tensor']}")
    for label, (family, _, control) in P12_CHECKS.items():
        base = _p13_base(family)
        if base not in refs:
            refs[base] = _p12d_reference(torch, base, dev, cfgs, routes)
            torch.cuda.empty_cache()
        want = refs[base]
        if family.startswith("lm") and family.endswith("_zero"):
            want = _clipped(torch, want, cfgs["clip"])
        e = _grad_errors(got[label], want)
        ok = _within(e, tol)
        if base == "vit":  # the update: the parameters it gave
            d = max(float((got["13c_states"][label][n] - w).abs().max())
                    for n, w in want[2].items())
            e["params"] = d
            ok = ok and d <= P12_PARAM_ATOL
        readings[label] = dict(loss=e["loss"], grad=e["grad"],
                               leaf=e["leaf"], attn=e["attn"],
                               **({"params": e["params"]} if "params" in e
                                  else {}))
        log(f"[mesh] 12d {label}: {_errors_text(e)}"
            + (f", updated parameters max |diff| {e['params']:.3e} (limit "
               f"{P12_PARAM_ATOL:.0e})" if "params" in e else "")
            + (" (a control: must fail)" if control else ""))
        if ok == bool(control):
            failed.append(f"12d {label}: " + ("the control passes" if control
                                              else _errors_text(e)))
    states = got["13c_states"]
    fp32, bf16 = (states[k] for k in ("13c vit zero data 4",
                                      "13c vit zero data 4, bf16 gather"))
    d = max(float((fp32[n] - bf16[n]).abs().max()) for n in fp32)
    readings["13c vit bf16 master vs fp32 gather"] = d
    log(f"[mesh] 13c vit zero data 4: the bf16 gather's master vs the fp32 "
        f"gather's parameters after one step: max |diff| {d:.3e} (limit "
        f"{P13_MASTER_ATOL:.0e})")
    if not d <= P13_MASTER_ATOL:
        failed.append(f"13c: the bf16 gather's master parts by {d:.3e}")
    return readings, failed


def _clipped(torch, ref, clip):
    """World 1's (loss, gradients) with the global-norm clip applied as
    the zero step applies it (``g / norm · clip`` where the norm reaches
    ``clip``)."""
    loss, grads = ref
    norm = float(torch.sqrt(sum(g.double().pow(2).sum()
                                for g in grads.values())))
    if norm < clip:
        return ref
    return loss, {k: (g / norm) * clip for k, g in grads.items()}


def check_mesh_spawn_params(torch, tmp, codes) -> tuple[dict, list]:
    """12d's spawned check (its run starts with the others; ``codes`` its
    exit code and lines): P12_SPAWN_ARGS at --mesh_seq 2 --spawn 2 --backend
    gloo against world 1, 2 fp32 SGD steps of the global batch 4 with
    --deterministic: the final parameters within P12_PARAM_ATOL; world 1
    with its gradient divided by the world once more must part by
    more."""
    from ddp_tpu_torch.train import optim

    if codes[0] != 0:
        return {}, [f"12d spawned: exit {codes[0]}: {codes[1][-20:]}"]
    _train(["--checkpoint_dir", f"{tmp}/p12_w1"], P12_SPAWN_ARGS)
    real = optim.Optimizer._update

    def divided(self):
        for p in self.params:
            p.grad.div_(P12_SPAWN_WORLD)
        real(self)

    with _patched((optim.Optimizer, "_update", divided)):
        _train(["--checkpoint_dir", f"{tmp}/p12_ctl"], P12_SPAWN_ARGS)

    def final(name):
        return torch.load(f"{tmp}/{name}/epoch_0/state.pt",
                          weights_only=True)

    a, b, c = final("p12_w1"), final("p12_seq2"), final("p12_ctl")

    def diff(p, q):
        return max(float((p[k].float() - q[k].float()).abs().max())
                   for k in p)

    d, dc = diff(b["params"], a["params"]), diff(c["params"], a["params"])
    log(f"[mesh] 12d spawned --mesh_seq 2 ({P12_SPAWN_WORLD} gloo ranks) vs "
        f"world 1 after {a['step']} SGD steps, fp32: max |param diff| "
        f"{d:.3e} (limit {P12_PARAM_ATOL:.0e}); control, the gradient "
        f"divided by the world once more: {dc:.3e}")
    failed = []
    if a["step"] != b["step"]:
        failed.append(f"12d spawned: steps {a['step']} vs {b['step']}")
    if not d <= P12_PARAM_ATOL:
        failed.append(f"12d spawned: parameters part by {d:.3e}")
    if dc <= P12_PARAM_ATOL:
        failed.append("12d spawned: the control passes")
    return dict(param_diff=d, control_diff=dc, steps=int(a["step"])), failed


@contextlib.contextmanager
def _killed(procs: dict):
    """``procs`` (name → process, filled inside the block), every one
    still running killed on the way out."""
    try:
        yield procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@contextlib.contextmanager
def _reaped(world):
    """Kill every process of ``world`` (12d's) still running on the way
    out."""
    try:
        yield
    finally:
        for proc in world.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def _rank_state(tmp, name, world) -> list[dict]:
    """Each rank's bytes at rest of a run (``state_rank<r>.json`` beside
    its trace: parameters, optimizer state)."""
    out = []
    for r in range(world):
        with open(f"{tmp}/{name}_prof/state_rank{r}.json") as f:
            out.append(json.load(f))
    return out


def check_fsdp_zero_runs(torch, tmp, runs) -> tuple[dict, list]:
    """13a and 13b beyond their launches: each rank's bytes of parameters
    and optimizer state at rest against what the specs and the bucket
    layout give (13a against 12b_seq2's, replicated over seq), and 13b's
    ``comm_bytes`` records against ``zero_comm_bytes``."""
    from ddp_tpu_torch.interop.jax_params import jax_leaf_order
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.models.lm import LMSpec, init_lm_state
    from ddp_tpu_torch.parallel import zero
    from ddp_tpu_torch.parallel.tp import seq_param_specs
    from ddp_tpu_torch.runtime.mesh import Mesh, mesh_sizes
    from ddp_tpu_torch.train.config import TrainConfig
    from ddp_tpu_torch.train.optim import make_optimizer

    failed, out = [], {}
    if not all(runs.get(n) for n in ("13a_fsdp2_seq2", "13b_vit_zero",
                                     "12b_seq2")):
        return out, ["13a/13b: a run failed: no state readings"]
    c = TrainConfig.from_args(P13A_ARGS)
    spec = LMSpec(vocab_size=c.vocab_size, total_len=c.seq_len,
                  d_model=c.model_dim, depth=c.model_depth,
                  num_heads=c.num_heads)
    shapes = {k: v.shape for k, v in init_lm_state(spec).items()}
    full = sum(int(np.prod(v)) for v in shapes.values()) * 4
    sizes = mesh_sizes(4, fsdp=2, seq=2)
    specs = seq_param_specs(shapes, Mesh(sizes, 0))
    local = sum(int(np.prod(v)) // int(np.prod(
        [sizes[a] for _, a in specs.get(k, ())])) for k, v in shapes.items()) * 4
    want = {"13a_fsdp2_seq2": local, "12b_seq2": full}
    for name, world in (("13a_fsdp2_seq2", 4), ("12b_seq2", 2)):
        st = _rank_state(tmp, name, world)
        out[name] = st
        for r, b in enumerate(st):
            # Adam: two moments a parameter and optax's int32 count.
            ok = (b["params"] == want[name]
                  and b["optimizer"] == 2 * want[name] + 4)
            log(f"[mesh] {name} rank {r}: at rest {b['params']} bytes of "
                f"parameters, {b['optimizer']} of Adam state (the specs "
                f"give {want[name]} and {2 * want[name] + 4})")
            if not ok:
                failed.append(f"{name} rank {r}: state {b} is not the "
                              "specs'")
    ratio = local / full
    log(f"[mesh] 13a: a rank's parameters and moments at fsdp 2 x seq 2 "
        f"are {out['13a_fsdp2_seq2'][0]['params'] / out['12b_seq2'][0]['params']:.4f}"
        f" of 12b_seq2's (the specs give {ratio:.4f}: every leaf but the "
        f"[1, L, d] position table halves)")
    out["13a_ratio"], out["13a_ratio_want"] = (
        out["13a_fsdp2_seq2"][0]["params"] / out["12b_seq2"][0]["params"],
        ratio)
    # 13b: ViT-Tiny's zero state against the DDP optimizer's, and the
    # records' comm_bytes against zero_comm_bytes.
    vit = get_model("vit_tiny", num_classes=100, side=32, in_channels=3)
    named = [(n, tuple(p.shape)) for n, p in vit.named_parameters()]
    order = jax_leaf_order([n for n, _ in named], [s for _, s in named])
    layout = zero.build_layout([named[i][1] for i in order], 2,
                               bucket_mb=4.0)
    ddp = zero.opt_bytes_per_device(make_optimizer(
        vit.parameters(), "sgd", lr=0.01, momentum=0.9))
    # SGD momentum's trace and the bf16 gather's fp32 master, 1/2 each.
    expect = 2 * (layout.padded_total // 2) * 4
    st = _rank_state(tmp, "13b_vit_zero", 2)
    out["13b_vit_zero"] = st
    for r, b in enumerate(st):
        log(f"[mesh] 13b rank {r}: at rest {b['optimizer']} bytes of "
            f"optimizer state (momentum and fp32 master shards; the layout "
            f"gives {expect}), {b['optimizer'] / ddp:.4f} of the DDP "
            f"optimizer's {ddp} (momentum alone, whole)")
        if b["optimizer"] != expect:
            failed.append(f"13b rank {r}: optimizer state {b['optimizer']} "
                          f"bytes, not {expect}")
    want_comm = zero.zero_comm_bytes(layout, 2, gather_dtype="bf16")["total"]
    with open(f"{tmp}/13b_vit_zero.jsonl") as f:
        comm = {r["comm_bytes"] for r in map(json.loads, f)
                if r.get("kind") == "step"}
    out["13b_comm_bytes"], out["13b_comm_bytes_want"] = sorted(comm), want_comm
    log(f"[mesh] 13b: comm_bytes in the step records {sorted(comm)}, "
        f"zero_comm_bytes gives {want_comm} a step (reduce-scatter fp32, "
        f"all-gather bf16)")
    if comm != {want_comm}:
        failed.append(f"13b: comm_bytes {sorted(comm)} != {want_comm}")
    return out, failed


def _p14_state_want(name, args, sizes, rank, zero1=False) -> dict:
    """The bytes a rank of a phase-14 run holds at rest by the specs: its
    parameters and its SGD momentum (the parameter's shard, or under
    --zero1 the ZeRO-1 slice)."""
    from ddp_tpu_torch.models import get_model
    from ddp_tpu_torch.parallel import spmd
    from ddp_tpu_torch.runtime.mesh import Mesh

    kw = dict(num_classes=100 if "cifar100" in args else 10, side=32,
              in_channels=3)
    if "--model_depth" in args:
        kw["depth"] = int(args[args.index("--model_depth") + 1])
    model = get_model(name, **kw)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = spmd.SpmdLayout(shapes, list(shapes), Mesh(sizes, rank),
                             zero1=zero1)

    def local(n, specs):
        div = 1
        for a in specs.get(n, ()):
            div *= sizes[a] if a else 1
        return int(np.prod(shapes[n])) // div * 4

    return dict(params=sum(local(n, layout.specs) for n in shapes),
                optimizer=sum(local(n, layout.state_specs) for n in shapes))


def check_p14_runs(torch, tmp, runs) -> tuple[dict, list]:
    """14a-14c beyond their launches: every rank's bytes of parameters and
    momentum at rest against the specs', 14a's launches all at one head
    a rank ([b, 65, 1, 64]) and its checkpoint restored by a world-1 run
    to the same parameters, bit for bit; the losses finite."""
    from ddp_tpu_torch.runtime.mesh import mesh_sizes

    failed, out = [], {}
    cases = {"14a_vit_model3": ("vit_tiny", P14A_ARGS, dict(model=3), False),
             "14b_moe_expert2": ("vit_moe_tiny", P14B_ARGS, dict(expert=2),
                                 False),
             "14c_resnet_fsdp2": ("resnet18", P14C_ARGS, dict(fsdp=2),
                                  False),
             "14c_resnet_zero1": ("resnet18", P14C_ARGS, {}, True)}
    for run, (name, args, axes, zero1) in cases.items():
        if not runs.get(run):
            failed.append(f"{run}: the run failed: no state readings")
            continue
        world = P12_RUNS[run][2]
        sizes = mesh_sizes(world, **axes)
        st = _rank_state(tmp, run, world)
        out[run] = [{k: v for k, v in b.items()} for b in st]
        for r, b in enumerate(st):
            want = _p14_state_want(name, args, sizes, r, zero1)
            shapes = b.get("flash_launch_shapes", {})
            log(f"[mesh] {run} rank {r}: at rest {b['params']} bytes of "
                f"parameters, {b['optimizer']} of momentum (the specs give "
                f"{want['params']} and {want['optimizer']}); B1-B3 by q's "
                f"shape {shapes}")
            if (b["params"], b["optimizer"]) != (want["params"],
                                                 want["optimizer"]):
                failed.append(f"{run} rank {r}: state {b['params']}, "
                              f"{b['optimizer']} is not the specs' {want}")
            if run.startswith("14a") and any(
                    set(v) != {P14A_SHAPE} for v in shapes.values()):
                failed.append(f"{run} rank {r}: B1-B3 on {shapes}, not "
                              f"one head a rank ({P14A_SHAPE})")
        blob = torch.load(f"{tmp}/{run}/epoch_0/state.pt", weights_only=True)
        with open(f"{tmp}/{run}.jsonl") as f:
            losses = [r["loss"] for r in map(json.loads, f)
                      if r.get("kind") == "step"]
        log(f"[mesh] {run}: step losses {losses}")
        if not losses or not all(np.isfinite(losses)):
            failed.append(f"{run}: losses {losses}")
        if run.startswith("14a"):
            trainer, _ = _train(["--checkpoint_dir", f"{tmp}/{run}",
                                 "--epochs", "1", "--synthetic_size", "128"],
                                base=P14A_ARGS)
            bad = [k for k, v in trainer.state.model.state_dict().items()
                   if not torch.equal(v.cpu(), blob["params"][k])]
            log(f"[mesh] 14a: rank 0's checkpoint restored by a world-1 "
                f"run: {len(bad)} parameters differ")
            if bad or trainer.state.step != blob["step"]:
                failed.append(f"14a: the world-1 restore differs: {bad[:4]}")
            out["14a_resume_differs"] = len(bad)
            del trainer
    return out, failed


def check_p14_steps(torch, tmp, dev="cuda") -> tuple[dict, list]:
    """14d (each P14_CHECKS mesh step against world 1's exact step, the
    controls failing) and 14e (shard_decode_attention's launches, bits
    and control) from 12d's world's files."""
    got = torch.load(f"{tmp}/12d_steps.pt", weights_only=False)
    masks, routes, p14e = {}, [], []
    for r in range(P12_WORLD):
        m, rt, e = torch.load(f"{tmp}/14d_rank{r}.pt", weights_only=False)
        for label, (dr, mk) in m.items():
            masks.setdefault(label, (None, []))[1].append((dr, mk))
        routes += rt
        p14e.append(e)
    cfgs = _p12_cfgs()
    tol = STEP_TOL["fp32"]
    readings, failed, refs = {}, [], {}
    for label, (family, _, zero1, control) in P14_CHECKS.items():
        base = label.split(",")[0]  # a control's uncontrolled run
        if base not in refs:
            refs[base] = _p14d_reference(torch, base, dev, cfgs, masks,
                                         routes)
        want, flips = refs[base]
        e = _grad_errors(got[label][:2], want[:2])
        d = max(float((got[label][2][n] - w).abs().max())
                for n, w in want[2].items())
        ok = _within(e, tol) and (not zero1 or d <= P12_PARAM_ATOL)
        extra = ""
        if family == "moe14" and control is None:
            drops = sum(int((~o.kept).sum()) for lab, _, o in routes
                        if lab == label)
            total = sum(o.kept.numel() for lab, _, o in routes
                        if lab == label)
            extra = f", {drops} of {total} (token, k) dropped"
            readings[label + " dropped"] = drops
            if not drops:
                failed.append(f"{label}: no token dropped at capacity "
                              f"factor {P14_MOE_CF}")
        if flips is not None:
            extra += f", {flips} ReLU sign(s) of world 1 off the mesh's masks"
        readings[label] = dict(loss=e["loss"], grad=e["grad"],
                               leaf=e["leaf"], params=d)
        log(f"[mesh] {label}: {_errors_text(e)}, updated parameters max "
            f"|diff| {d:.3e}{extra}"
            + (" (a control: must fail)" if control else ""))
        if ok == bool(control):
            failed.append(f"{label}: " + ("the control passes" if control
                                          else _errors_text(e)))
        torch.cuda.empty_cache()
    by_rank = {}
    for r, cases in enumerate(p14e):
        for (tp, kv, L, q8), c in cases.items():
            key = (f"model {tp}, H_kv {kv}, L {L}, "
                   + ("int8 (B5)" if q8 else "fp32 (B4)"))
            whole = kv % tp != 0
            by_rank.setdefault(key, []).append(c["launches"])
            ok = (c["launches"] == 1 and c["bitwise"]
                  and c["plain_err"] <= KERNEL_ATOL
                  and c["whole"] == int(whole)
                  and (whole or c["control_err"] > KERNEL_ATOL))
            if r == 0 or not ok:
                log(f"[mesh] 14e rank {r} {key}: {c['launches']} launch(es)"
                    f"{' (the whole-head call)' if whole else ''}, bitwise "
                    f"the world-1 kernel's: {c['bitwise']}, max |err| vs "
                    f"plain {c['plain_err']:.2e}, off-by-one head offset "
                    f"{c['control_err']:.2e}")
            if not ok:
                failed.append(f"14e rank {r} {key}: {c}")
    readings["14e_launches_by_rank"] = by_rank
    return readings, failed


def _p15_cfg(family, pipe, virtual, cfgs):
    """A 15c/15d family's PipeLMConfig or PipeViTConfig."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv

    if family == "vit":
        return tpv.PipeViTConfig(**cfgs["p15_vit"], num_stages=pipe,
                                 virtual_stages=virtual)
    return tplm.PipeLMConfig(**cfgs["p15_lm"], num_stages=pipe,
                             virtual_stages=virtual)


def _p15_inputs(torch, family, pipe, virtual, dev, cfgs, rows=None):
    """(the config, the seeded full state, the global batch) of a 15c/15d
    case: by default one row a microbatch a data replica of 12d's world."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv

    cfg = _p15_cfg(family, pipe, virtual, cfgs)
    rows = rows or cfg.num_microbatches * (P12_WORLD // pipe)
    rng = np.random.default_rng(15)
    if family == "vit":
        state = tpv.init_pipe_vit(cfg, seed=15, interleaved=virtual > 1)
        x = rng.integers(0, 256, (rows, cfg.side, cfg.side, cfg.in_channels),
                         dtype=np.uint8)
        y = rng.integers(0, cfg.num_classes, rows)
        return cfg, state, (torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    state = tplm.init_pipe_lm(cfg, seed=15, interleaved=virtual > 1)
    toks = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len))
    return cfg, state, (torch.from_numpy(toks).to(dev),)


def _p15_step(torch, family, schedule, cfg, state, batch, mesh, dev, *,
              grads=True):
    """One fp32 SGD step of a pipe world on this rank's rows of ``batch``
    → (loss, the full gradients gathered over pipe, or None)."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv
    from ddp_tpu_torch.train.optim import make_optimizer

    inter = schedule == "interleaved"
    build, make = ((tpv.build_pipe_vit, tpv.make_pipe_vit_train_step)
                   if family == "vit" else
                   (tplm.build_pipe_lm, tplm.make_pipe_lm_train_step))
    model = build(cfg, state, mesh, dev, interleaved=inter)
    opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
    opt.norm = model.shard_layout.norm
    per = batch[0].shape[0] // mesh.data_size
    rows = [b[mesh.data_rank * per:][:per] for b in batch]
    m = make(model, opt, mesh, schedule=schedule)(*rows)
    out = None
    if grads:
        out = model.shard_layout.gather(
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    return float(m.loss), out


def _p15_worker_steps(torch, mesh_of, dev, cfgs, rank) -> dict:
    """15c's steps and 15d's peaks on this rank of 12d's world → what
    rank 0 saves (15c: label → (loss, full gradients); 15d: (schedule,
    M) → stage 0's peak allocated bytes and what it held before)."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.parallel import interleaved as tinter
    from ddp_tpu_torch.parallel import one_f1b as tf1b

    faults = {"dropped_backward": (tf1b, "FAULT", (0, 1)),
              "untied_head": (tplm, "FAULT", "untied_head"),
              "stage_major": (tinter, "FAULT", "stage_major")}
    out = {}
    for label, (family, pipe, virtual, schedule, control) in \
            P15_CHECKS.items():
        mesh = mesh_of(dict(pipe=pipe))
        cfg, state, batch = _p15_inputs(torch, family, pipe, virtual, dev,
                                        cfgs)
        with _patched(*([faults[control]] if control else [])):
            out[label] = _p15_step(torch, family, schedule, cfg, state,
                                   batch, mesh, dev)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    mesh = mesh_of(dict(pipe=2))
    for schedule in ("gpipe", "1f1b"):
        for M in P15D_MICROBATCHES:
            cfgs_m = dict(cfgs, p15_lm=dict(cfgs["p15_lm"],
                                            num_microbatches=M))
            cfg, state, batch = _p15_inputs(torch, "lm", 2, 1, dev, cfgs_m,
                                            rows=M * mesh.data_size)
            held = peak = 0
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            _p15_step(torch, "lm", schedule, cfg, state, batch, mesh, dev,
                      grads=False)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
            out[("15d", schedule, M, rank)] = (held, peak)
    return out


def _p15_reference(torch, family, pipe, virtual, dev, cfgs):
    """World 1's exact sequential step (fp32, the plain attention) of a
    15c case from the same weights on the global batch → (loss, {full
    name: gradient})."""
    return _pipe_reference(torch, family, *_p15_inputs(
        torch, family, pipe, virtual, dev, cfgs), dev)


def _pipe_reference(torch, family, cfg, state, batch, dev):
    """World 1's exact sequential step (fp32, the plain attention) of a
    pipe model ``cfg`` from its full ``state`` on the global ``batch`` →
    (loss, {full name: gradient}); the LM's through its ``to_dense_lm``
    (routed blocks routed over the whole batch: at a capacity that drops
    nothing, the pipeline's per-microbatch routing's)."""
    import torch.nn.functional as F

    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv
    from ddp_tpu_torch.ops import flash as fl
    from ddp_tpu_torch.parallel import ring
    from ddp_tpu_torch.parallel.common import _preprocess, precision
    from ddp_tpu_torch.train.optim import make_optimizer

    if family == "lm":
        spec, dense = tplm.to_dense_lm(cfg, state)
        # The pipe path collects no load-balance loss (pipeline_lm.py:91).
        spec = spec._replace(aux_loss_weight=0.0)
        model = tlm.CausalLM.from_state(spec, dense, dev, trainable=True)
        opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
        m = tlm.make_lm_train_step(model, opt,
                                   block_fn=ring._xla_block_with_lse)(*batch)
        return float(m.loss), {n: p.grad.detach().cpu()
                               for n, p in model.named_parameters()}

    def plain(q, k, v):
        return fl.attention_with_lse_reference(q, k, v, False)[0]

    def load(module, prefix, source):
        module.load_state_dict({k[len(prefix):]: torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in source.items()
            if k.startswith(prefix)})
        return module.to(dev)

    embed = load(tpv.PatchEmbed(cfg), "embed.", state)
    head = load(tpv.PipeHead(cfg), "head.", state)
    chunks = []
    for c in tpv.chunk_states(state):
        blocks = tpv.StageBlocks(cfg.depth_per_stage, cfg.embed_dim,
                                 cfg.num_heads, cfg.embed_dim * cfg.mlp_ratio,
                                 attention_fn=plain)
        chunks.append(load(blocks, "", c))
    with precision(torch.float32):  # the patch conv in full fp32
        h = embed(_preprocess(batch[0], torch.float32))
        for blocks in chunks:
            h = blocks(h, torch.float32)
        loss = F.cross_entropy(head(h), batch[1].long())
        loss.backward()
    loss = loss.detach()
    grads = {f"embed.{n}": p.grad.cpu() for n, p in embed.named_parameters()}
    grads.update({f"head.{n}": p.grad.cpu()
                  for n, p in head.named_parameters()})
    for n, _ in chunks[0].named_parameters():
        stacked = torch.stack([dict(b.named_parameters())[n].grad.cpu()
                               for b in chunks])
        grads["stages." + n] = stacked.reshape(state["stages." + n].shape)
    return float(loss), grads


def check_p15_steps(torch, tmp, dev="cuda") -> tuple[dict, list]:
    """15c (each P15_CHECKS pipe world's step against world 1's exact
    step, the controls failing) and 15d (the 1F1B memory contract) from
    12d's world's file."""
    from ddp_tpu_torch.models import pipeline_lm as tplm

    got = torch.load(f"{tmp}/15_steps.pt", weights_only=False)
    cfgs = _p12_cfgs()
    tol = STEP_TOL["fp32"]
    readings, failed, refs = {}, [], {}
    for label, (family, pipe, virtual, _, control) in P15_CHECKS.items():
        key = (family, pipe, virtual)
        if key not in refs:
            refs[key] = _p15_reference(torch, family, pipe, virtual, dev,
                                       cfgs)
            torch.cuda.empty_cache()
        loss, grads = got[label]
        if family == "lm":  # the stacked names → the dense CausalLM's
            grads = tplm.to_dense_lm(_p15_cfg(family, pipe, virtual, cfgs),
                                     grads)[1]
        e = _grad_errors((loss, grads), refs[key])
        ok = _within(e, tol)
        readings[label] = dict(loss=e["loss"], grad=e["grad"], leaf=e["leaf"])
        log(f"[mesh] {label}: {_errors_text(e)}"
            + (" (a control: must fail)" if control else ""))
        if ok == bool(control):
            failed.append(f"{label}: " + ("the control passes" if control
                                          else _errors_text(e)))
    peaks = {}
    for key, (held, peak) in got.items():
        if isinstance(key, tuple):  # ("15d", schedule, M, rank 0)
            _, schedule, M, _ = key
            peaks[f"{schedule} M {M}"] = dict(held_mb=held / 2**20,
                                              peak_mb=peak / 2**20)
    lo, hi = (peaks[f"1f1b M {M}"]["peak_mb"] for M in P15D_MICROBATCHES)
    glo, ghi = (peaks[f"gpipe M {M}"]["peak_mb"] for M in P15D_MICROBATCHES)
    log(f"[mesh] 15d stage 0 (rank 0, pipe 2 x data 2, microbatches of one "
        f"row of T {cfgs['p15_lm']['seq_len']}, fp32) peak allocated over a "
        f"step: 1f1b M {P15D_MICROBATCHES[0]} {lo:.1f} MiB, M "
        f"{P15D_MICROBATCHES[1]} {hi:.1f} MiB (ratio {hi / max(lo, 1):.3f}, "
        f"limit {P15_MEMORY_RATIO}); gpipe {glo:.1f} MiB and {ghi:.1f} MiB "
        f"(ratio {ghi / max(glo, 1):.3f}); held before each step: "
        f"{[round(v['held_mb'], 1) for v in peaks.values()]} MiB")
    readings["15d"] = peaks
    if not hi <= P15_MEMORY_RATIO * lo:
        failed.append(f"15d: 1F1B stage 0's peak grows with M: {lo:.1f} -> "
                      f"{hi:.1f} MiB")
    return readings, failed


def _p15_resume_failures(torch, ckdir, args, dev="cuda") -> list[str]:
    """Rank 0's checkpoint of a 15a run restored by each pipe rank (the
    trainer's path: ``CheckpointManager(layout=)`` at the same mesh): its
    parameters, Adam moments and count are the file's slices, bit for
    bit."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.parallel.ddp import TrainState
    from ddp_tpu_torch.train.checkpoint import CheckpointManager
    from ddp_tpu_torch.train.config import TrainConfig
    from ddp_tpu_torch.train.optim import make_optimizer

    c = TrainConfig.from_args(args + ["--spawn", "2"])
    inter = c.pipe_schedule == "interleaved"
    cfg = tplm.PipeLMConfig(
        vocab_size=c.vocab_size, seq_len=c.seq_len, d_model=c.model_dim,
        num_heads=c.num_heads, num_stages=c.mesh_pipe,
        depth_per_stage=c.model_depth, num_microbatches=c.num_microbatches,
        virtual_stages=c.virtual_stages)
    blob = torch.load(f"{ckdir}/epoch_0/state.pt", weights_only=True)
    failed = []
    for d in range(c.mesh_pipe):
        model = tplm.PipeLM(cfg, d, interleaved=inter).to(dev)
        layout = model.layout(comm=None)
        opt = make_optimizer(model.parameters(), "adam", lr=c.lr)
        st = TrainState(0, model, opt)
        CheckpointManager(ckdir, layout=layout).restore(st)
        want = layout.shard(blob["params"])
        moments = {k: layout.shard(blob["opt_state"][k]) for k in ("mu",
                                                                 "nu")}
        for n, p in model.named_parameters():
            i = layout.names.index(n)
            if not (torch.equal(p.detach().cpu(), want[n])
                    and all(torch.equal(getattr(opt, k)[i].cpu(),
                                        moments[k][n]) for k in moments)):
                failed.append(f"pipe rank {d}: {n} restored off its slice")
        if (st.step, opt.count) != (blob["step"], blob["opt_state"]["count"]):
            failed.append(f"pipe rank {d}: step {st.step}, count "
                          f"{opt.count} restored")
    return failed


def _p15_dense_loss(torch, ckdir, args, dev="cuda") -> float:
    """A 15a checkpoint's ``to_dense_lm`` through the port's CausalLM
    (bf16, as the run evaluated) on the run's test split → the mean of
    its per-sequence losses."""
    from ddp_tpu_torch.models import lm as tlm
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.train.config import TrainConfig
    from ddp_tpu_torch.train.trainer import build_splits

    c = TrainConfig.from_args(args + ["--spawn", "2"])
    cfg = tplm.PipeLMConfig(
        vocab_size=c.vocab_size, seq_len=c.seq_len, d_model=c.model_dim,
        num_heads=c.num_heads, num_stages=c.mesh_pipe,
        depth_per_stage=c.model_depth, virtual_stages=c.virtual_stages)
    params = torch.load(f"{ckdir}/epoch_0/state.pt",
                        weights_only=True)["params"]
    spec, dense = tplm.to_dense_lm(cfg, params)
    model = tlm.CausalLM.from_state(spec, dense, dev)
    tokens = torch.as_tensor(build_splits(c)[1].images).to(dev)
    _, loss = tlm.make_lm_eval_step(model, compute_dtype=torch.bfloat16)(
        tokens, torch.ones(tokens.shape[0], device=dev))
    return float(loss) / tokens.shape[0]


def check_p15_runs(torch, tmp, runs, dev="cuda") -> tuple[dict, list]:
    """15a and 15b beyond their launches: finite losses in each run's
    --metrics_file; 15a's checkpoint restored bit for bit by each pipe
    rank, and its to_dense_lm's eval loss the pipeline's within
    P15_DENSE_ATOL; the timetables' bubble fractions."""
    from ddp_tpu_torch.parallel.interleaved import schedule_interleaved
    from ddp_tpu_torch.parallel.pipeline import bubble_fraction

    readings, failed = {}, []
    for name, (base, extra, _) in P15_RUNS.items():
        if name not in runs or not runs[name]:
            continue  # its exit already failed the phase
        args = base + extra
        with open(f"{tmp}/{name}.jsonl") as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if r["kind"] == "step"]
        final = next(r for r in recs if r["kind"] == "final")
        if not (losses and all(np.isfinite(losses))
                and np.isfinite(final["loss"])):
            failed.append(f"{name}: losses {losses}, eval {final['loss']}")
        M = int(_flag(args, "--num_microbatches", 4))
        V = int(_flag(args, "--virtual_stages", 1))
        bubble = (schedule_interleaved(2, M, V).bubble_fraction() if V > 1
                  else bubble_fraction(2, M))
        r = dict(losses=losses, eval_loss=final["loss"], bubble=bubble)
        if name.startswith("15a"):
            bad = _p15_resume_failures(torch, f"{tmp}/{name}", args, dev)
            dense = _p15_dense_loss(torch, f"{tmp}/{name}", args, dev)
            r.update(resumed_bitwise=not bad, dense_eval_loss=dense)
            failed += [f"{name}: {b}" for b in bad]
            if not abs(dense - final["loss"]) <= P15_DENSE_ATOL:
                failed.append(f"{name}: to_dense_lm's eval loss {dense} vs "
                              f"the pipeline's {final['loss']}")
            torch.cuda.empty_cache()
        readings[name] = r
        log(f"[mesh] {name}: step losses {losses}, eval loss "
            f"{final['loss']:.6f}"
            + (f", to_dense_lm's {r['dense_eval_loss']:.6f} (limit "
               f"{P15_DENSE_ATOL:.0e}), checkpoint restored bit for bit by "
               f"every pipe rank: {r['resumed_bitwise']}"
               if name.startswith("15a") else "")
            + f"; the timetable's bubble fraction {bubble:.3f}")
    return readings, failed


def _p16_replicas(axes) -> int:
    """A 16c mesh's data replicas in 12d's world: data × fsdp × expert."""
    return (P12_WORLD // int(np.prod(list(axes.values())))
            * axes.get("fsdp", 1) * axes.get("expert", 1))


def _p16_inputs(torch, label, dev, cfgs, state=True):
    """(the config, the seeded full state, the global batch: M rows a
    data replica) of a 16c case; without ``state``, the config alone."""
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv

    family, axes, virtual, _, fields, _ = cfgs["p16"][label]
    pipe = axes["pipe"]
    base = dict(cfgs["p15_vit" if family == "vit" else "p15_lm"], **fields)
    cls = tpv.PipeViTConfig if family == "vit" else tplm.PipeLMConfig
    cfg = cls(**base, num_stages=pipe, virtual_stages=virtual)
    if not state:
        return (cfg,)
    rows = cfg.num_microbatches * _p16_replicas(axes)
    rng = np.random.default_rng(16)
    if family == "vit":
        state = tpv.init_pipe_vit(cfg, seed=16, interleaved=virtual > 1)
        x = rng.integers(0, 256, (rows, cfg.side, cfg.side, cfg.in_channels),
                         dtype=np.uint8)
        y = rng.integers(0, cfg.num_classes, rows)
        return cfg, state, (torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    state = tplm.init_pipe_lm(cfg, seed=16, interleaved=virtual > 1)
    toks = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len))
    return cfg, state, (torch.from_numpy(toks).to(dev),)


def _p16_worker_steps(torch, mesh_of, dev, cfgs) -> dict:
    """16c's steps on this rank of 12d's world → what rank 0 saves:
    label → (loss, the full gradients gathered over every axis, the
    (token, k) assignments routing dropped on this rank)."""
    from ddp_tpu_torch.models import moe as tmoe
    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.parallel import pipeline as tpipe
    from ddp_tpu_torch.parallel import tp as ttp

    faults = {"fsdp_unsummed": (tpipe, "FAULT", "fsdp_unsummed"),
              "unsummed_f": (ttp, "FAULT", "unsummed_f"),
              "expert_summed": (tpipe, "FAULT", "expert_summed"),
              "no_pos_offset": (tplm, "FAULT", "no_pos_offset")}
    real_route, out, inputs = tmoe.route, {}, {}
    for label, (family, axes, virtual, schedule, fields, control) in \
            cfgs["p16"].items():
        t0, dropped = time.perf_counter(), []

        def route(*a, **kw):
            r = real_route(*a, **kw)
            dropped.append(int((~r.kept).sum()))
            return r

        key = (family, virtual, tuple(sorted(fields.items())),
               tuple(sorted(axes.items())))
        if key not in inputs:  # a control shares its case's
            inputs[key] = _p16_inputs(torch, label, dev, cfgs)
        cfg, state, batch = inputs[key]
        with _patched((tmoe, "route", route),
                      *([faults[control]] if control else [])):
            loss, grads = _p15_step(torch, family, schedule, cfg, state,
                                    batch, mesh_of(axes), dev)
        out[label] = (loss, grads, sum(dropped), time.perf_counter() - t0)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def check_p16_steps(torch, tmp, dev="cuda") -> tuple[dict, list]:
    """16c: each P16_CHECKS composition's step against world 1's exact
    step (STEP_TOL["fp32"]), every control failing, no routed token
    dropped, from 12d's world's file."""
    from ddp_tpu_torch.models import pipeline_lm as tplm

    got = torch.load(f"{tmp}/16_steps.pt", weights_only=False)
    cfgs = _p12_cfgs()
    tol = STEP_TOL["fp32"]
    readings, failed, refs = {}, [], {}
    parallel = ("tp_size", "ep_size", "sp_size", "sp_strategy")
    for label, (family, axes, virtual, _, fields, control) in \
            P16_CHECKS.items():
        cfg = _p16_inputs(torch, label, dev, cfgs, state=False)[0]
        # One reference a model and global batch: the axes that do not
        # change either (model, expert, seq, the schedule) share it.
        key = (family, virtual, _p16_replicas(axes),
               tuple(sorted((k, v) for k, v in fields.items()
                            if k not in parallel)))
        if key not in refs:
            refs[key] = _pipe_reference(
                torch, family, *_p16_inputs(torch, label, dev, cfgs), dev)
            torch.cuda.empty_cache()
        loss, grads, dropped, seconds = got[label]
        if family == "lm":  # the stacked names → the dense CausalLM's
            grads = tplm.to_dense_lm(cfg, grads)[1]
        e = _grad_errors((loss, grads), refs[key])
        ok = _within(e, tol)
        readings[label] = dict(loss=e["loss"], grad=e["grad"], leaf=e["leaf"],
                               dropped=dropped, seconds=seconds)
        log(f"[mesh] {label}: {_errors_text(e)}, (token, k) dropped on rank 0"
            f": {dropped}; {seconds:.1f} s in the world"
            + (" (a control: must fail)" if control else ""))
        if ok == bool(control):
            failed.append(f"{label}: " + ("the control passes" if control
                                          else _errors_text(e)))
        if dropped:
            failed.append(f"{label}: {dropped} (token, k) dropped at the "
                          "capacity factor E/k")
    return readings, failed


def _p16_state_want(args, world, rank) -> dict:
    """The bytes a rank of a 16a run holds at rest by the specs
    (``pipe_common.stage_specs``): its ends whole, its chunks' leaves
    each its pipe slice cut over its axes, fp32; Adam two moments a
    parameter and the int32 count, SGD's momentum one."""
    import torch

    from ddp_tpu_torch.models import pipeline_lm as tplm
    from ddp_tpu_torch.models import pipeline_vit as tpv
    from ddp_tpu_torch.parallel.pipe_common import stage_specs
    from ddp_tpu_torch.runtime.mesh import Mesh, mesh_sizes
    from ddp_tpu_torch.train.config import TrainConfig

    c = TrainConfig.from_args(args + ["--spawn", str(world)])
    inter = c.pipe_schedule == "interleaved"
    sizes = mesh_sizes(world, pipe=c.mesh_pipe, model=c.mesh_model,
                       expert=c.mesh_expert, fsdp=c.mesh_fsdp,
                       seq=c.mesh_seq)
    with torch.device("meta"):
        if c.model == "pipe_lm":
            cfg = tplm.PipeLMConfig(
                vocab_size=c.vocab_size, seq_len=c.seq_len,
                d_model=c.model_dim, num_heads=c.num_heads,
                num_stages=c.mesh_pipe, depth_per_stage=c.model_depth,
                virtual_stages=c.virtual_stages, num_experts=c.moe_experts,
                moe_every=c.moe_every)
            model = tplm.PipeLM(cfg, 0, interleaved=inter)
        else:
            cfg = tpv.PipeViTConfig(
                num_classes=100, patch_size=4, embed_dim=c.model_dim,
                num_heads=c.num_heads, num_stages=c.mesh_pipe,
                depth_per_stage=c.model_depth, side=32, in_channels=3)
            model = tpv.PipeViT(cfg, 0, interleaved=inter)
    lead = (c.virtual_stages, c.mesh_pipe) if inter else (c.mesh_pipe,)
    full = {}
    for n, p in model.named_parameters():
        if n.startswith("chunks.0."):
            full["stages." + n[len("chunks.0."):]] = lead + tuple(p.shape)
        elif not n.startswith("chunks."):
            full[n] = tuple(p.shape)
    specs = stage_specs(full, Mesh(sizes, rank), lead=len(lead),
                        tp=c.mesh_model, ep=c.mesh_expert)
    params = 0
    for n, shape in full.items():
        numel = int(np.prod(shape))
        if n.startswith("stages."):
            numel //= c.mesh_pipe * int(np.prod(
                [sizes[a] for _, a in specs.get(n[len("stages."):], ())]))
        params += numel * 4
    adam = c.optimizer == "adam"
    return dict(params=params, optimizer=2 * params + 4 if adam else params)


def check_p16_runs(torch, tmp, runs, wave_peak_mib, dev="cuda"
                   ) -> tuple[dict, list]:
    """16a beyond the launches its readings gated: every B1-B3 launch on
    its composition's q (P16_Q); each rank's bytes of parameters and
    optimizer state at rest against the specs'; finite losses; the PP x
    TP run's checkpoint restored at --mesh_pipe 2 (no model axis) by each
    pipe rank to the file's full state, bit for bit; the second wave's
    peak memory under the card's."""
    readings, failed = {"wave_peak_mib": wave_peak_mib}, []
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    log(f"[mesh] phases 15's and 16's wave: peak {wave_peak_mib} MiB of "
        f"the card's {total:.0f} used (nvidia-smi, every second)")
    if not wave_peak_mib or wave_peak_mib >= total:
        failed.append(f"the second wave's peak {wave_peak_mib} MiB")
    for name, (base, extra, world) in P16_RUNS.items():
        if not runs.get(name):
            failed.append(f"{name}: the run failed: no readings")
            continue
        args = base + extra
        st = _rank_state(tmp, name, world)
        dt = _p15_dtype(name)
        for r, b in enumerate(st):
            want = _p16_state_want(args, world, r)
            shapes = {k: v for k, v in b.get("flash_launch_shapes",
                                             {}).items() if v}
            log(f"[mesh] {name} rank {r}: at rest {b['params']} bytes of "
                f"parameters, {b['optimizer']} of optimizer state (the specs "
                f"give {want['params']} and {want['optimizer']}); B1-B3 by "
                f"q's shape {shapes}")
            if (b["params"], b["optimizer"]) != (want["params"],
                                                 want["optimizer"]):
                failed.append(f"{name} rank {r}: state {b['params']}, "
                              f"{b['optimizer']} is not the specs' {want}")
            if set(shapes) != {f"{n}_{dt}" for n in FLASH_NAMES} or any(
                    set(v) != {P16_Q[name]} for v in shapes.values()):
                failed.append(f"{name} rank {r}: B1-B3 on {shapes}, not all "
                              f"on {P16_Q[name]} in {dt}")
        with open(f"{tmp}/{name}.jsonl") as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if r["kind"] == "step"]
        final = next(r for r in recs if r["kind"] == "final")
        if not (losses and all(np.isfinite(losses))
                and np.isfinite(final["loss"])):
            failed.append(f"{name}: losses {losses}, eval {final['loss']}")
        readings[name] = dict(state=st, losses=losses,
                              eval_loss=final["loss"])
        if name == "16a_pp_tp":
            bad = _p15_resume_failures(torch, f"{tmp}/{name}",
                                       args + ["--mesh_model", "1"], dev)
            readings[name]["restored_at_pipe_2_bitwise"] = not bad
            failed += [f"{name} at --mesh_pipe 2: {b}" for b in bad]
            torch.cuda.empty_cache()
        restored = readings[name].get("restored_at_pipe_2_bitwise")
        log(f"[mesh] {name}: step losses {losses}, eval loss "
            f"{final['loss']:.6f}"
            + (f"; its checkpoint restored at --mesh_pipe 2 bit for bit by "
               f"every pipe rank: {restored}" if name == "16a_pp_tp" else ""))
    return readings, failed


def _memory_peak():
    """Start a thread reading the card's used memory (nvidia-smi) every
    second → (a dict whose ``mib`` is the highest reading, the function
    that stops the thread and prints it)."""
    peak, stop = {"mib": 0}, threading.Event()

    def poll():
        while not stop.is_set():
            try:
                used = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.split()
                peak["mib"] = max(peak["mib"], int(used[0]))
            except (OSError, ValueError, IndexError,
                    subprocess.SubprocessError):
                pass
            stop.wait(1.0)

    thread = threading.Thread(target=poll, name="memory peak", daemon=True)
    thread.start()

    def done():
        stop.set()
        thread.join()
        log(f"[mesh] the card's used memory peaked at {peak['mib']} MiB")

    return peak, done


def check_mesh(torch, card) -> dict:
    """Phase 12, the sequence models across ranks: 12a the long-context
    model at README's command (--mesh_seq 4, ring and Ulysses), 12b the
    LM at run_lm_long_bench's width (--mesh_seq 2, --mesh_model 2, both),
    12c the routed LM at --mesh_expert 2, each `python -m
    ddp_tpu_torch.train --spawn N --backend gloo` with every rank on the
    one card (one wave, half of it WAVE_STAGGER s late, with 12d's
    world), launches by rank from each rank's trace; the ring hops' B1-B3
    timed alone; 12d the step checks. Phases 13 and 14 ride the same wave;
    phases 15 and 16 (the pipeline and its compositions) a second wave
    after it, their steps in 12d's world; each wave's peak of the card's
    used memory is printed. Every reading is printed before any
    raise."""
    import tempfile

    t0 = s0 = time.perf_counter()
    failed, readings = [], {"runs": {}}

    def lap(label):
        nonlocal s0
        log(f"[mesh] {label}: {time.perf_counter() - s0:.1f} s")
        s0 = time.perf_counter()

    dev = "cpu" if CNN_DEVICE_ARGS else "cuda"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp, \
            _killed({}) as second:
        w0, started = time.perf_counter(), time.time()
        world = start_mesh_steps(tmp, dev)
        with _reaped(world):
            commands = {name: _p12_argv(name, tmp) for name in P12_RUNS
                        if name not in PIPE_RUNS}
            commands["spawned"] = P12_SPAWN_ARGS + CNN_DEVICE_ARGS + GLOO + [
                "--mesh_seq", "2", "--spawn", str(P12_SPAWN_WORLD),
                "--checkpoint_dir", f"{tmp}/p12_seq2"]
            first_peak, stop_polling = _memory_peak()
            try:
                procs = {}
                _launch_staggered(commands, tmp, procs, WAVE_STAGGER).join()
                done = _await_all(procs, tmp, timeout=P12_RUN_TIMEOUT)
            finally:
                stop_polling()
            readings["first_wave_peak_mib"] = first_peak["mib"]
            spawned = done.pop("spawned")
            span = (started, time.time())
            for name, (code, lines) in done.items():
                readings["runs"][name], bad = _p12_readings(
                    torch, tmp, name, code, lines, span)
                failed += bad
            lap(f"the runs ({len(commands)} at once, 12d's world beside "
                "them)")
            readings["phase13"], bad = check_fsdp_zero_runs(
                torch, tmp, readings["runs"])
            failed += bad
            readings["flash"] = check_and_time_flash(torch, HOP12A_SHAPE,
                                                     "hop12a", seed=121)
            readings["flash"].update(check_and_time_flash(
                torch, HOP12B_SHAPE, "hop12b", seed=122))
            readings["flash"].update(check_and_time_flash(
                torch, P14A_FLASH_SHAPE, "vit14a", seed=141))
            readings["flash"].update(check_and_time_flash(
                torch, P15A_SHAPE, "pipe15a", seed=151))
            readings["flash"].update(check_and_time_flash(
                torch, P16A_SHAPE, "pipe16", seed=161))
            lap("hops, 14a's, 15a's and 16a's shapes timed")
            # Phases 15's and 16's runs, a second wave: the first wave
            # alone peaks at ~75 GB of the card's 80 (every run of a try at
            # one wave died of CUDA's out of memory); they start after the
            # kernel timings above (which they would crowd) and run beside
            # the checks below, the card's used memory read every second.
            started15 = time.time()
            wave_peak, stop_polling = _memory_peak()
            halves = _launch_staggered(
                {name: _p12_argv(name, tmp) for name in PIPE_RUNS}, tmp,
                second, WAVE_STAGGER)
            readings["steps"], bad = check_mesh_steps(torch, tmp, world, w0,
                                                      dev)
        failed += bad
        lap("12d steps")
        if not any(b.startswith("12d: ") for b in bad):
            readings["phase14_steps"], bad = check_p14_steps(torch, tmp, dev)
            failed += bad
            readings["phase15_steps"], bad = check_p15_steps(torch, tmp, dev)
            failed += bad
            readings["phase16_steps"], bad = check_p16_steps(torch, tmp, dev)
            failed += bad
        readings["phase14"], bad = check_p14_runs(torch, tmp,
                                                  readings["runs"])
        failed += bad
        lap("phases 14's, 15's and 16's checks")
        readings["spawned"], bad = check_mesh_spawn_params(torch, tmp,
                                                           spawned)
        failed += bad
        lap("12d spawned")
        try:
            halves.join()
            done = _await_all(second, tmp, timeout=P12_RUN_TIMEOUT)
        finally:
            stop_polling()
        span = (started15, time.time())
        for name, (code, lines) in done.items():
            readings["runs"][name], bad = _p12_readings(
                torch, tmp, name, code, lines, span)
            failed += bad
        lap(f"phases 15's and 16's runs ({len(second)} at once, after the "
            "first wave)")
        readings["phase15"], bad = check_p15_runs(torch, tmp,
                                                  readings["runs"], dev)
        failed += bad
        readings["phase16"], bad = check_p16_runs(
            torch, tmp, readings["runs"], wave_peak["mib"], dev)
        failed += bad
        lap("phases 15's and 16's runs checked")
    log(f"[mesh] phases 12, 13, 14, 15 and 16: "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    if failed:
        raise AssertionError(f"phases 12, 13, 14, 15 and 16: {failed}")
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
    counted, defaults = {}, {}
    for kv_dtype, name in (("fp32", "flash_decode_fp32"),
                           ("int8", "flash_decode_int8")):
        defaults[kv_dtype], engine = serve_run(torch, model, prompts,
                                               kv_dtype=kv_dtype)
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
    counted["flags"] = check_serving_flags(torch, model, prompts, defaults)
    return counted


def _requests_traffic(url, prompts, requests=None) -> dict:
    """Every request of ``requests`` (default REQUESTS) posted at once
    over HTTP → {index: reply}."""
    requests = requests or REQUESTS
    replies, errors = {}, []

    def client(i):
        _, n_new, sampling = requests[i]
        try:
            replies[i] = _post(url, {"prompt_tokens": prompts[i],
                                     "max_new_tokens": n_new, **sampling})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("; ".join(errors) or "a client did not finish")
    return replies


# Phase 4's flag runs through the CLI: (label, KV dtype, extra flags).
FLAG_RUNS = [("fp32", "fp32", ["--decode_attn", "flash"]),
             ("int8", "int8", []),
             ("paged fp32", "fp32", ["--page_size", str(SERVE_PAGE)])]
QUEUE_BURST = 16  # the --max_queue 2 run's concurrent requests


def check_serving_flags(torch, model, prompts, defaults) -> dict:
    """Phase 4's flag runs: ``python -m ddp_tpu_torch.serve``'s main()
    with SERVE_FLAGS (chunk 32, min bucket 8, 40 tokens a step), parsed
    by its own argparse, serving phase 4's workload at full width in fp32
    (``--decode_attn flash``), int8 and paged fp32. Each: every request
    complete; compile_counts() after the traffic equal to its value after
    warmup() and to FLAG_COMPILE_COUNTS (JAX's warmup() for these flags);
    decode launches = decode steps x depth of the run's kernel and none
    of another. fp32 greedy streams equal phase 4's default-flag run's
    (fixed-lane and paged), parted only at a near tie (counted). int8
    streams are compared and the parted ones counted, not gated: the
    chunk split decides which K/V a chunk attends quantized (a first
    chunk its own fp32 K/V, a later one the int8 lane), so another split
    is another int8 computation, in the JAX engine too. Then a small
    model with ``--decode_attn reference --max_queue 2``: a burst past
    the queue answers 429, and no decode kernel launches → {kernel:
    launches}."""
    from ddp_tpu_torch.ops import decode as dec

    spec = model.spec
    base = ["--init_demo", "--seed", "0",
            "--vocab_size", str(spec.vocab_size),
            "--seq_len", str(spec.total_len), "--d_model", str(spec.d_model),
            "--depth", str(spec.depth), "--num_heads", str(spec.num_heads),
            "--slots", str(SLOTS), "--prefill_len", str(PREFILL_LEN),
            *SERVE_FLAGS]
    greedy = [i for i, (_, _, s) in enumerate(REQUESTS) if not s]
    counted, failed, parted = {}, [], {}
    for label, kv_dtype, extra in FLAG_RUNS:
        out = {}

        def traffic(url, made, stop):
            out["replies"] = _requests_traffic(url, prompts)

        t0 = time.perf_counter()
        made, lines = serve_main_with(
            torch, base + ["--kv_dtype", kv_dtype, *extra], traffic)
        wall = time.perf_counter() - t0
        flat, paged, routed = _lm_launches(dec)
        engine = made[0]
        kernel = ("flash_decode_paged_fp32" if engine.paged else
                  f"flash_decode_{kv_dtype}")
        got = {**flat, **paged}
        want = engine.decode_steps * spec.depth
        start = json.loads(next(line for line in lines
                                if line.startswith('{"serving"')))
        after = engine.compile_counts()
        replies = out["replies"]
        bad = [i for i, r in replies.items() if r["status"] != "complete"
               or len(r["tokens"]) != REQUESTS[i][1]]
        n, fails = _stream_failures(
            torch, model, prompts, {i: replies[i]["tokens"] for i in greedy},
            {i: defaults[kv_dtype][i]["tokens"] for i in greedy}, kv_dtype,
            f"flags {label}")
        parted[label] = n
        log(f"[serve-flags] {label} ({' '.join(SERVE_FLAGS + extra)}): "
            f"{len(replies)} requests in {wall:.1f} s (server start "
            f"included), {engine.decode_steps} decode steps; chunk "
            f"{engine.prefill_chunk}, buckets {engine.buckets}, budget "
            f"{engine.step_token_budget}; compile_counts after warmup "
            f"{start['compile_counts']}, after the traffic {after} (want "
            f"{FLAG_COMPILE_COUNTS}); launches {got} (want {kernel} = "
            f"{want}), routed {routed}; greedy streams vs the default-flag "
            f"run: {len(greedy) - n} identical, {n} parted"
            + (" at a near tie" if not fails else ""))
        if bad:
            failed.append(f"{label}: requests {bad} did not complete")
        if not (start["compile_counts"] == after == FLAG_COMPILE_COUNTS):
            failed.append(f"{label}: compile counts {start['compile_counts']}"
                          f" then {after}, not {FLAG_COMPILE_COUNTS}")
        if (got[kernel] != want or want == 0 or routed
                or sum(got.values()) != got[kernel]):
            failed.append(f"{label}: launches {got}, routed {routed}, want "
                          f"{kernel} = {want}")
        if engine.prefill_chunk != 32 or engine.step_token_budget != 40:
            failed.append(f"{label}: the flags did not reach the engine")
        if kv_dtype == "fp32":
            failed += [f"{label}: {f}" for f in fails]
        counted[kernel] = counted.get(kernel, 0) + got[kernel]
    # --decode_attn reference and --max_queue 2, on a small model.
    out = {}
    small = dict(FULL, d_model=256, depth=2)
    burst = [(8, 64, {})] * QUEUE_BURST

    def queue_traffic(url, made, stop):
        codes = []

        def client(i):
            req = urllib.request.Request(
                url + "/generate", method="POST", data=json.dumps(
                    {"prompt_tokens": list(range(1, 9)),
                     "max_new_tokens": 64}).encode())
            try:
                with urllib.request.urlopen(req, timeout=900) as r:
                    codes.append((r.status, json.loads(r.read())["status"]))
            except urllib.error.HTTPError as e:
                codes.append((e.code, json.loads(e.read()).get("error")))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        out["codes"] = sorted(codes)

    made, _ = serve_main_with(torch, [
        "--init_demo", "--seed", "0", "--vocab_size", str(small["vocab_size"]),
        "--seq_len", str(small["total_len"]), "--d_model",
        str(small["d_model"]), "--depth", str(small["depth"]), "--num_heads",
        str(small["num_heads"]), "--slots", str(SLOTS), "--max_queue", "2",
        "--decode_attn", "reference", *SERVE_FLAGS], queue_traffic)
    flat, paged, routed = _lm_launches(dec)
    codes = out["codes"]
    n429 = sum(c == 429 and e == "queue_full" for c, e in codes)
    done = sum(c == 200 and e == "complete" for c, e in codes)
    log(f"[serve-flags] --decode_attn reference --max_queue 2, a burst of "
        f"{len(burst)} at once: {done} complete, {n429} answered 429 "
        f"queue_full; engine attn {made[0].decode_attn}; decode launches "
        f"{flat} {paged}, routed {routed}")
    if (n429 == 0 or done + n429 != len(burst) or any(flat.values())
            or any(paged.values()) or made[0].decode_attn != "reference"):
        failed.append(f"--max_queue 2 / --decode_attn reference: codes "
                      f"{codes}, launches {flat} {paged}")
    log(f"[serve-flags] greedy streams parted from the default-flag run "
        f"(near ties for fp32; int8 not gated): {parted}")
    if failed:
        raise AssertionError(f"phase 4 flag runs: {failed}")
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


# --step-spread: the seeds 10b's and 10a's step checks are read at, on
# the committed IMAGENET_TRAIN-image split (seed 0 twice: a rerun must repeat its
# reading), and the batches of ResNet-50's card-vs-fp64 step.
SPREAD_VIT_SEEDS = (0, 0, 1, 2, 3, 4)
SPREAD_RESNET_SEEDS = (0, 1)
SPREAD_RESNET_BATCHES = (2, 4)


def step_spread_main() -> int:
    """``--step-spread``: 10b's and 10a's step checks over seeds. For each
    of SPREAD_VIT_SEEDS (``--seed``: the weights, the order and the
    augmentation), 10b's ViT-Tiny 224² run, then 10b's check_vit_step on
    its first 8 images: the bf16 gate (BF16_GATE_RATIO against SDPA's
    distance from the exact step), the old 2e-2 reading, the fp32 gate,
    and both negative controls (a B1 that counts the last tile's
    zero-filled keys, a B3 that drops key row 3136), each of which must
    fail at every seed. For each of SPREAD_RESNET_SEEDS, 10a's fp32
    ResNet-50 run, then its card-vs-fp64 step at each of
    SPREAD_RESNET_BATCHES. Prints the card and one JSON line; exits 1
    when a gate fails or a control passes at any seed."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from ddp_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("flash_attn.cu",))
    card = card_line()
    vit, resnet, bad = [], [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spread_") as tmp:
        data = f"{tmp}/imagenet"
        write_imagenet(data, IMAGENET_TRAIN)
        for i, seed in enumerate(SPREAD_VIT_SEEDS):
            trainer, _ = _train(["--data_root", data, "--checkpoint_dir",
                                 f"{tmp}/vit{i}", "--seed", str(seed)],
                                VIT224_ARGS)
            row = {"seed": seed}
            failed = check_vit_step(torch, trainer, batch=8,
                                    tag=f"spread vit224 seed {seed}",
                                    tail=True, record=row)
            log(f"[spread] vit_tiny 224² seed {seed}: "
                + ("every gate holds and every control fails" if not failed
                   else str(failed)))
            row["failed"] = failed
            bad += failed
            vit.append(row)
            del trainer
            torch.cuda.empty_cache()
        for seed in SPREAD_RESNET_SEEDS:
            trainer, _ = _train(["--data_root", data, "--checkpoint_dir",
                                 f"{tmp}/rn{seed}", "--compute_dtype",
                                 "float32", "--seed", str(seed)],
                                RESNET50_ARGS)
            for batch in SPREAD_RESNET_BATCHES:
                failed = check_resnet_step(
                    torch, trainer, batch=batch,
                    tag=f"spread resnet50 seed {seed} batch {batch}",
                    gated=("trained",), control="trained", against="fp64")
                log(f"[spread] resnet50 seed {seed} batch {batch}: "
                    + ("within 10a's limits" if not failed else str(failed)))
                bad += failed
                resnet.append({"seed": seed, "batch": batch,
                               "within": not failed})
            del trainer
            torch.cuda.empty_cache()
    log(card)
    print(json.dumps({"card": card, "vit224": vit, "resnet50": resnet}),
          flush=True)
    return 1 if bad else 0


def main() -> int:
    if "--time-flash" in sys.argv:
        return time_flash_main(sys.argv)
    if "--time-decode" in sys.argv:
        return time_decode_main(sys.argv)
    if "--time-serve" in sys.argv:
        return time_serve_main(sys.argv)
    if "--step-spread" in sys.argv:
        return step_spread_main()
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
    # Both sources' nvcc start together; the decode phases (3-4h, which
    # launch no flash-attention kernel) run beside flash_attn.cu's build,
    # which phase 3b joins (a load of it before then waits for the build).
    attn_build = {}

    def build_attn():
        try:
            attn_build["seconds"] = _build.build(("flash_attn.cu",))
        except BaseException as e:  # raised again by the join below
            attn_build["error"] = e

    builder = threading.Thread(target=build_attn, name="nvcc flash_attn.cu")
    builder.start()
    seconds = _build.build(("flash_decode.cu",))
    log(f"[build] {json.dumps(seconds)} (wall {time.perf_counter() - t0:.2f} s)")
    log_decode_ptxas(_build)

    def timed(label, fn, *args):
        s0 = time.perf_counter()
        out = fn(*args)
        log(f"[main] {label}: {time.perf_counter() - s0:.1f} s")
        return out

    timings = timed("phase 3", check_kernels, torch)
    paged_timings = timed("phase 3c", check_paged_kernels, torch)
    launches = timed("phase 4", check_serving, torch)
    paged_launches = timed("phase 4c", check_paged_serving, torch)
    spec_launches = timed("phase 4d", check_spec_serving, torch, card)
    obs = timed("phase 4e", check_serving_obs, torch, card)
    graphs = timed("phase 4f", check_graphs, torch, card)
    moe = timed("phase 4g", check_moe_serving, torch, card)
    timed("phase 4h", check_moe_layer, torch)
    builder.join()
    if "error" in attn_build:
        raise attn_build["error"]
    log(f"[build] {json.dumps(attn_build['seconds'])} (beside phases 3-4h)")
    log_ptxas(_build)
    flash = timed("phase 3b", check_flash, torch)
    trained, served = timed("phases 5 and 8", check_lm_phases, torch, card)
    timed("phase 6", check_cnn, torch, card)
    images = timed("phase 7", check_image_families, torch, card)
    fault = timed("phase 9", check_fault_tolerance, torch, card)
    imagenet = timed("phase 10", check_imagenet, torch, card)
    lc = timed("phase 11", check_long_context, torch, card)
    mesh = timed("phases 12-16", check_mesh, torch, card)
    log(f"[main] all phases and the build: {time.perf_counter() - t0:.1f} s")

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
    # Phase 14e: shard_decode_attention's launches by rank of 12d's world,
    # each case's key "model tp, H_kv n, L n, fp32 (B4)|int8 (B5)".
    for k, tag in ((kernels[0], "fp32"), (kernels[1], "int8")):
        k["shard_decode_launches_by_rank"] = {
            case: counts for case, counts in
            mesh["phase14_steps"]["14e_launches_by_rank"].items()
            if tag in case}
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
    # Phase 4's flag runs (SERVE_FLAGS through the serve CLI): B4 fp32
    # with --decode_attn flash, B5 int8, B4p paged fp32.
    for k in kernels:
        k["flag_launches"] = launches["flags"].get(k["name"], 0)
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
        vit_launches = {d: images["vit"][k][name] for d, k in
                        (("bf16", "launches"), ("fp32", "launches_fp32"))}
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
            # Phase 10: ViT-Tiny at 224² (T 3137) training (10b) and its
            # --remat run (10c; B1 twice a block).
            "imagenet_launches": {
                "vit224": imagenet["vit"]["launches"][name],
                "vit224_remat": imagenet["remat"]["launches"][name]},
            # Phase 11: the long-context classifier's training (11a; T
            # 8192, D 16, non-causal; ring in both dtypes, then Ulysses)
            # and the causal LM at T 8192 (11d).
            "long_context_launches": {
                "bf16": lc["train"]["bf16"]["launches"][name],
                "fp32": lc["train"]["fp32"]["launches"][name],
                "ulysses_bf16": lc["train"]["ulysses_bf16"][name]},
            "lm_long_launches": lc["lm_long"]["launches"][name],
            # 11f's world-2 rank 0, from its profiler trace (fp32).
            "lm_world2_rank0_launches":
                lc["world2"]["launches"].get(f"{name}_fp32", 0),
            # Phase 12: each --spawn run's training launches by rank
            # (bf16, from each rank's trace): 12a long_context at
            # --mesh_seq 4 (ring, Ulysses), 12b the LM at T 8192
            # (--mesh_seq 2, --mesh_model 2, both), 12c --mesh_expert 2.
            "mesh_launches_by_rank": {
                run: [rk["train"][f"{name}_bf16"] for rk in r["ranks"]]
                for run, r in mesh["runs"].items()},
            # Phase 14: the GSPMD runs' training launches by rank (14a
            # ViT-Tiny at --mesh_model 3, one head a rank; 14b vit_moe_tiny
            # at --mesh_expert 2).
            "gspmd_launches_by_rank": {
                run: [rk["train"][f"{name}_bf16"]
                      for rk in mesh["runs"][run]["ranks"]]
                for run in ("14a_vit_model3", "14b_moe_expert2")},
            # Phase 15: the pipe runs' training launches by pipe rank
            # (15a pipe_lm under gpipe, 1f1b and interleaved, bf16; 15b
            # pipe_vit under 1f1b, fp32: JAX's promotion), each the
            # timetable's count (B1 twice a block under the hand-
            # scheduled schedules).
            "pipe_launches_by_rank": {
                run: [rk["train"][f"{name}_{_p15_dtype(run)}"]
                      for rk in mesh["runs"][run]["ranks"]]
                for run in PIPE_RUNS},
            "variants": {
                "fp32": {"launches": trained["fp32"][name],
                         **{k: flash["fp32"][name][k] for k in keys}},
                **{f"vit_{d}": {"launches": vit_launches[d],
                                **{k: flash[f"vit_{d}"][name][k]
                                   for k in keys},
                                "sdpa_bwd_ms":
                                    flash[f"vit_{d}"][name]["sdpa_bwd_ms"]}
                   for d in ("bf16", "fp32")},
                **{f"vit224_{d}": {
                    "launches": imagenet["vit"][
                        "launches" if d == "bf16" else "launches_fp32"][name],
                    **{k: imagenet["flash"][f"vit224_{d}"][name][k]
                       for k in keys},
                    "sdpa_bwd_ms":
                        imagenet["flash"][f"vit224_{d}"][name]["sdpa_bwd_ms"]}
                   for d in ("bf16", "fp32")},
                **{f"long_context_{d}": {
                    "launches": lc["train"][d]["launches"][name],
                    **lc["flash"][f"long_context_{d}"][name]}
                   for d in ("bf16", "fp32")},
                **{f"lm_long_{d}": {
                    "launches": lc["lm_long"][
                        "launches" if d == "bf16" else "launches_fp32"][name],
                    **lc["flash"][f"lm_long_{d}"][name]}
                   for d in ("bf16", "fp32")},
                # The ring hops' shapes (non-causal past hops), timed
                # alone; launches: those at that shape in 12a ring
                # (every hop) and 12b seq 2 (the past hops alone).
                **{f"{hop}_{d}": {
                    "launches": _hop_launches(mesh["runs"][run],
                                              f"{name}_{d}", causal),
                    **mesh["flash"][f"{hop}_{d}"][name]}
                   for hop, run, causal in (("hop12a", "12a_ring", False),
                                            ("hop12b", "12b_seq2", True))
                   for d in ("bf16", "fp32")},
                # Phase 14a's shape, one head a rank ([64, 65, 1, 64]);
                # launches: 14a's over its 3 ranks (bf16).
                **{f"vit14a_{d}": {
                    "launches": sum(
                        rk["train"][f"{name}_{d}"] for rk in
                        mesh["runs"]["14a_vit_model3"]["ranks"]),
                    **mesh["flash"][f"vit14a_{d}"][name]}
                   for d in ("bf16", "fp32")},
                # Phase 15a's microbatch ([2, 2048, 8, 128], causal);
                # launches: 15a's three runs over their ranks.
                **{f"pipe15a_{d}": {
                    "launches": sum(
                        rk["train"][f"{name}_{d}"] for run in P15_RUNS
                        if run.startswith("15a")
                        for rk in mesh["runs"][run]["ranks"]),
                    **mesh["flash"][f"pipe15a_{d}"][name]}
                   for d in ("bf16", "fp32")},
                # Phase 16a's PP x TP microbatch ([1, 2048, 4, 128],
                # causal); launches: that run's over its 4 ranks.
                **{f"pipe16_{d}": {
                    "launches": sum(
                        rk["train"][f"{name}_{d}"]
                        for rk in mesh["runs"]["16a_pp_tp"]["ranks"]),
                    **mesh["flash"][f"pipe16_{d}"][name]}
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
