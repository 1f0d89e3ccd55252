"""Serving CLI: stand up the continuous-batching engine behind HTTP.

    python -m ddp_tpu_torch.train --model causal_lm --checkpoint_dir ck ...
    python -m ddp_tpu_torch.serve --checkpoint_dir ck --page_size 16 \\
        --port 8000
    curl -s localhost:8000/generate -d \\
        '{"prompt_tokens": [1, 2, 3], "max_new_tokens": 32}'
    curl -s localhost:8000/reload -d '{"checkpoint_dir": "ck", "epoch": 3}'

The weights come from one of three sources. ``--checkpoint_dir`` serves
a checkpoint of ``python -m ddp_tpu_torch.train --model causal_lm``
(``--epoch``, default the latest intact one), its architecture taken
from the parameter shapes and the ``lm_spec.json`` sidecar beside the
epochs (``--num_heads`` only for a checkpoint without one);
``--init_demo`` serves seeded random weights (``--seed``);
``--params_npz`` serves a JAX causal-LM parameter tree saved as a flat
``/``-keyed ``.npz`` (``numpy.savez(path, **{"/".join(keys): leaf})``),
mapped by ``interop/jax_params.py``. Runs on the GPU, where decode
attention always goes through the CUDA flash-decode kernel (its paged
form with ``--page_size``), unless ``--device cpu`` is given (the plain
versions run there). Prints one JSON line when it serves, then serves
until SIGTERM, which drains (new requests answer 503, running ones
finish, up to ``--drain_timeout`` seconds), or Ctrl-C.

``POST /reload`` hot-swaps a verified checkpoint of the same spec
(``serve/lifecycle.py``); ``--streaming_restore`` opens admission once
the embedding and the first ``--stream_layers`` blocks are on the
device, and dispatches once the rest is. ``--model NAME=DIR`` (again for
more) serves another checkpoint as its own engine, reached by
``"model": NAME`` in a request.

``--spec_tokens N`` serves with speculative decoding: a draft model
proposes N tokens a step (through the flash-decode kernel on its own
fp32 cache) and the target verifies them in one step, the streams
unchanged. The draft is ``--draft_checkpoint_dir`` (its latest intact
epoch), ``--draft_params_npz`` (a JAX tree, as ``--params_npz``, with
``--num_heads`` heads) or, under ``--init_demo``, a seeded half-width,
half-depth sibling of the demo model (seed 1); it must share the
target's vocabulary and total_len.

Observability (``ddp_tpu_torch/obs``): ``GET /metricsz`` (Prometheus
text) and ``GET /statusz`` always; ``--trace_dir`` turns on the span
tracer's measuring mode, serves its tail at /statusz and exports
``trace_rank{--trace_rank}.trace.json`` there on shutdown;
``--reqtrace`` gives every request a trace id and a timeline at
``GET /requestz?id=<rid|0xTRACE>``; ``--slo "ttft_p99<0.5s,..."``
evaluates objectives live (per model: ``"clauses;NAME:clauses"``);
``--flight_dir`` receives the flight recorder's dump on shutdown.

    curl -s localhost:8000/metricsz
    curl -s localhost:8000/statusz
    curl -s 'localhost:8000/requestz?id=0'

Before it serves, each engine (the main one and every ``--model``)
prepares its whole step-program set (``ServeEngine.warmup()``): on the
GPU every decode, speculative and prefill-chunk step is captured as a
CUDA graph then, so no request meets a capture; the startup line
carries ``compile_counts`` and the graphs' pool bytes. ``--no_warmup``
skips it (each program is then prepared at its first use).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--init_demo", action="store_true",
                     help="serve seeded random weights")
    src.add_argument("--params_npz", default=None,
                     help="JAX parameter tree as a flat '/'-keyed .npz")
    src.add_argument("--checkpoint_dir", default=None,
                     help="a causal-LM checkpoint directory of "
                     "python -m ddp_tpu_torch.train")
    p.add_argument("--epoch", type=int, default=None,
                   help="--checkpoint_dir epoch (default: the latest "
                   "intact one)")
    p.add_argument("--seed", type=int, default=0,
                   help="--init_demo weight seed")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--seq_len", type=int, default=128,
                   help="--init_demo context length (total_len)")
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4,
                   help="attention heads of --init_demo and --params_npz "
                   "(shapes do not carry them), and of a checkpoint "
                   "without an lm_spec.json sidecar")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prefill_len", type=int, default=None,
                   help="longest admissible prompt (default total_len/2)")
    p.add_argument(
        "--prefill_chunk", type=int, default=None,
        help="chunked-prefill width (rounded to a power of two; "
        "default min(pow2(prefill_len), 64)) — prompts are ingested "
        "in chunks co-scheduled with decode steps",
    )
    p.add_argument(
        "--min_bucket", type=int, default=None,
        help="smallest power-of-two bucket for the final partial "
        "chunk (default min(8, prefill_chunk); clamped so the "
        "smallest bucket always fits total_len - prefill_len + 1) — "
        "short prompts pay bucket-sized compute, not "
        "prefill_len-sized",
    )
    p.add_argument(
        "--step_token_budget", type=int, default=None,
        help="max prefill-chunk tokens + decode tokens dispatched "
        "per engine step (default prefill_chunk + slots)",
    )
    p.add_argument("--max_queue", type=int, default=64,
                   help="queued requests beyond which /generate answers "
                   "429")
    p.add_argument(
        "--decode_attn", default="auto",
        choices=["auto", "flash", "reference"],
        help="single-query decode attention (ops/decode.py): 'flash' "
        "is the CUDA flash-decode kernel (B4/B5, their paged forms "
        "under --page_size; raises where the kernel cannot take the "
        "model's heads), 'reference' the plain PyTorch version; 'auto' "
        "takes the kernel on the GPU where it takes the shape",
    )
    p.add_argument("--kv_dtype", default="fp32", choices=["fp32", "int8"])
    p.add_argument(
        "--page_size", type=int, default=0,
        help="paged KV + radix prefix cache (serve/pages.py): KV lives in "
        "a pool of this-many-token pages and prompts sharing a prefix "
        "prefill it once and fork the pages copy-free (power of two "
        "dividing total_len; 0 = the fixed-lane cache)",
    )
    p.add_argument(
        "--kv_pages", type=int, default=None,
        help="page-pool size for --page_size (default: slots x "
        "total_len/page_size + 1 scratch — capacity-neutral vs fixed "
        "lanes; smaller pools lean on prefix sharing, admission waits "
        "on free pages)",
    )
    p.add_argument("--spec_tokens", type=int, default=0,
                   help="speculative decoding: draft tokens per step "
                   "(0 = off)")
    p.add_argument("--draft_checkpoint_dir", default=None,
                   help="the draft's checkpoint directory")
    p.add_argument("--draft_params_npz", default=None,
                   help="the draft's JAX parameter tree, as --params_npz")
    p.add_argument("--model", action="append", default=None,
                   metavar="NAME=DIR",
                   help="serve the checkpoint in DIR as model NAME as well "
                   "(repeatable)")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="seconds SIGTERM waits for running requests")
    p.add_argument("--streaming_restore", action="store_true",
                   help="--checkpoint_dir: open admission once the "
                   "embedding and the first --stream_layers blocks are "
                   "on the device; dispatch once all of it is")
    p.add_argument("--stream_layers", type=int, default=1,
                   help="blocks that gate admission under "
                   "--streaming_restore")
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--trace_dir", default=None,
                   help="span-trace chunk/decode/verify/sample work (the "
                   "measuring mode: each span waits on the engine's "
                   "stream), serve the tail at /statusz and export a "
                   "Perfetto trace_event JSON here on shutdown")
    p.add_argument("--trace_ring_events", type=int, default=65536,
                   help="bounded trace memory: keep the last N events")
    p.add_argument("--trace_rank", type=int, default=0,
                   help="tracer process id: names the exported file "
                   "(trace_rank{N}.trace.json) and scopes span pairing in "
                   "a merged document")
    p.add_argument("--reqtrace", action="store_true",
                   help="per-request tracing: a 64-bit trace id at "
                   "admission, the lifecycle at /requestz?id=..., "
                   "exported as Perfetto async spans under --trace_dir")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="serving objectives over rolling 5m/1h windows, "
                   "e.g. 'ttft_p99<0.5s,tpot_p50<80ms,availability>0.999'; "
                   "per model 'clauses;NAME:clauses' — state on /statusz, "
                   "ddp_tpu_slo_* gauges on /metricsz, breaches into the "
                   "metrics stream and the flight recorder")
    p.add_argument("--flight_dir", default=None,
                   help="flight-recorder directory: the ring (SLO breach "
                   "records) is dumped here on shutdown "
                   "(flight_rank0.json)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip preparing the engine program set before "
                   "serving (each CUDA graph is then captured at its first "
                   "use, inside a request)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    if args.streaming_restore and not args.checkpoint_dir:
        p.error("--streaming_restore needs --checkpoint_dir")
    from ddp_tpu_torch.obs.slo import SLOEngine, parse_model_slos

    # Per-model groups: each registered model gets its own SLOEngine.
    try:
        model_slos = parse_model_slos(args.slo) if args.slo else {}
    except ValueError as e:
        raise SystemExit(f"--slo: {e}")
    registered = {m.partition("=")[0] for m in args.model or []}
    for name in model_slos:
        if name is not None and name not in registered:
            raise SystemExit(f"--slo names model {name!r} but no --model "
                             f"{name}=DIR registers it")

    from ddp_tpu_torch.device import resolve_device
    from ddp_tpu_torch.models.lm import CausalLM, LMSpec, init_lm
    from ddp_tpu_torch.obs.recorder import (
        FlightRecorder,
        build_info,
        snapshot_env,
    )
    from ddp_tpu_torch.obs.tracer import Tracer
    from ddp_tpu_torch.serve.engine import ServeEngine
    from ddp_tpu_torch.serve.lifecycle import StreamingRestore
    from ddp_tpu_torch.serve.server import LMServer
    from ddp_tpu_torch.utils.metrics import MetricsWriter

    device = resolve_device(args.device)
    streaming = epoch = version = None
    if args.streaming_restore:
        try:
            streaming = StreamingRestore(
                args.checkpoint_dir, device=device, epoch=args.epoch,
                first_blocks=args.stream_layers,
                num_heads_fallback=args.num_heads)
        except (FileNotFoundError, RuntimeError, ValueError) as e:
            raise SystemExit(f"--checkpoint_dir {args.checkpoint_dir}: {e}")
        epoch, version = streaming.epoch, streaming.version
        model = CausalLM.from_state(streaming.spec,
                                    streaming.placeholder_state(), device)
        streaming.start()
    elif args.checkpoint_dir:
        model, epoch, version = _load_checkpoint(
            "--checkpoint_dir", args.checkpoint_dir, args.epoch,
            args.num_heads, device)
    elif args.params_npz:
        model = _load_npz("--params_npz", args.params_npz,
                          args.num_heads, device)
    else:
        model = init_lm(LMSpec(
            vocab_size=args.vocab_size, total_len=args.seq_len,
            d_model=args.d_model, depth=args.depth,
            num_heads=args.num_heads,
        ), seed=args.seed, device=device)
    spec = model.spec
    draft = None
    if args.spec_tokens:
        if args.draft_checkpoint_dir:
            draft, _, _ = _load_checkpoint(
                "--draft_checkpoint_dir", args.draft_checkpoint_dir, None,
                args.num_heads, device)
        elif args.draft_params_npz:
            draft = _load_npz("--draft_params_npz", args.draft_params_npz,
                              args.num_heads, device)
        elif args.init_demo:
            draft = init_lm(
                spec._replace(d_model=max(16, spec.d_model // 2),
                              depth=max(1, spec.depth // 2)),
                seed=1, device=device)
        else:
            raise SystemExit(
                "--spec_tokens needs --draft_checkpoint_dir or "
                "--draft_params_npz (or --init_demo, which synthesizes a "
                "draft)"
            )
        for field in ("vocab_size", "total_len"):
            if getattr(draft.spec, field) != getattr(spec, field):
                raise SystemExit(
                    f"the draft's {field} {getattr(draft.spec, field)} "
                    f"differs from the target's {getattr(spec, field)}: a "
                    "draft must share the target's vocabulary and length"
                )
    metrics = MetricsWriter(args.metrics_file)
    tracer = Tracer(enabled=bool(args.trace_dir),
                    ring_events=args.trace_ring_events,
                    process_id=args.trace_rank)
    recorder = FlightRecorder(args.flight_dir)
    recorder.set_context(build_info=build_info(device), env=snapshot_env(),
                         slo=args.slo, role="serve")

    def slo_for(name):
        return SLOEngine(model_slos[name]) if model_slos.get(name) else None

    knobs = dict(slots=args.slots, metrics=metrics, kv_dtype=args.kv_dtype,
                 page_size=args.page_size, kv_pages=args.kv_pages,
                 prefill_chunk=args.prefill_chunk,
                 min_bucket=args.min_bucket,
                 step_token_budget=args.step_token_budget,
                 max_queue=args.max_queue, decode_attn=args.decode_attn)
    engine = ServeEngine(
        model, prefill_len=args.prefill_len, spec_tokens=args.spec_tokens,
        draft_model=draft, model_version=version, tracer=tracer,
        reqtrace=args.reqtrace, slo=slo_for(None), recorder=recorder,
        **knobs)
    if streaming is not None:
        engine.pause_admission()  # requests queue until the weights land
    models = {}
    for entry in args.model or []:
        name, _, mdir = entry.partition("=")
        if not name or not mdir:
            raise SystemExit(f"--model wants NAME=DIR, got {entry!r}")
        if name in models:
            raise SystemExit(f"--model {name!r} registered twice")
        mmodel, _, mversion = _load_checkpoint(
            f"--model {name}", mdir, None, args.num_heads, device)
        models[name] = ServeEngine(mmodel, model_version=mversion,
                                   slo=slo_for(name), **knobs)
    if not args.no_warmup:
        # The whole program set before the first request (under
        # --streaming_restore, while the restore thread copies: graphs
        # read the weights' addresses, and install_params copies into
        # them).
        for eng in [engine, *models.values()]:
            eng.warmup()
    # SIGTERM only sets an event: this thread wakes, drains and returns.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        with LMServer(engine, host=args.host, port=args.port,
                      models=models) as server:
            if streaming is not None:
                streaming.wait_admission()
            print(json.dumps({
                "serving": server.url,
                "device": str(engine.device),
                "spec": spec._asdict(),
                "slots": engine.num_slots,
                "prefill_len": engine.prefill_len,
                "prefill_chunk": engine.prefill_chunk,
                "buckets": engine.buckets,
                "step_token_budget": engine.step_token_budget,
                "decode_attn": engine.decode_attn,
                "kv_dtype": engine.kv_dtype,
                "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
                "compile_counts": engine.compile_counts(),
                "cuda_graphs": engine.cuda_graphs,
                "graph_pool_bytes": engine.graph_pool_bytes(),
                "build_info": build_info(device),
                "reqtrace": bool(args.reqtrace),
                **({"slo": args.slo} if args.slo else {}),
                **({"page_size": engine.page_size,
                    "kv_pages": engine.kv_pages} if engine.paged else {}),
                **({"spec_tokens": engine.spec_tokens,
                    "draft_spec": draft.spec._asdict()}
                   if engine.spec_tokens else {}),
                **({"model_version": version, "epoch": epoch}
                   if version is not None else {}),
                **({"models": sorted(models)} if models else {}),
                **({"streaming_restore": {
                    "admission_ready_s": streaming.admission_ready_s,
                    "admission_group": streaming.admission_group}}
                   if streaming is not None else {}),
            }), flush=True)
            if streaming is not None:
                # The whole state goes in through the hot-swap path; a
                # failed stream is fatal (never serve the placeholder).
                full = streaming.wait(timeout=600.0)
                with server._lock:
                    engine.install_params(full, model_version=version)
                    engine.resume_admission()
                print(json.dumps({
                    "streamed": True,
                    "admission_ready_s": streaming.admission_ready_s,
                    "complete_s": streaming.complete_s,
                }), flush=True)
            try:
                stop.wait()
            except KeyboardInterrupt:
                pass
            if stop.is_set():
                drained = server.drain(args.drain_timeout)
                print(json.dumps({"draining": True, "drained": drained,
                                  "drain_timeout": args.drain_timeout}),
                      flush=True)
    finally:
        # The telemetry tail survives a short session: request spans,
        # then the trace (an unwritable --trace_dir must not turn a
        # clean shutdown into a crash), then the flight dump (never
        # raises).
        if args.trace_dir:
            try:
                engine.emit_request_spans()
                path = tracer.export_to_dir(args.trace_dir)
                print(json.dumps({"trace": path}), flush=True)
            except OSError as e:
                print(json.dumps({"trace_error": str(e)}), file=sys.stderr,
                      flush=True)
        dump = recorder.dump("shutdown")
        if dump:
            print(json.dumps({"flight": dump}), flush=True)
        metrics.close()


def _load_checkpoint(flag: str, directory: str, epoch, num_heads: int,
                     device):
    """A causal LM from a checkpoint directory → (model, epoch, version
    label); the spec from its shapes and its ``lm_spec.json``."""
    from ddp_tpu_torch.models.lm import CausalLM
    from ddp_tpu_torch.serve.lifecycle import model_version_token
    from ddp_tpu_torch.train.checkpoint import (
        CheckpointManager,
        derive_spec_with_sidecar,
    )

    try:
        state, epoch = CheckpointManager(directory).restore_for_inference(
            epoch)
        spec = derive_spec_with_sidecar(directory, state,
                                        num_heads_fallback=num_heads)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        raise SystemExit(f"{flag} {directory}: {e}")
    return (CausalLM.from_state(spec, state, device), epoch,
            model_version_token(directory, epoch))


def _load_npz(flag: str, path: str, num_heads: int, device):
    """A causal LM from a flat '/'-keyed JAX tree saved as ``.npz``."""
    from ddp_tpu_torch.interop.jax_params import lm_params_from_jax
    from ddp_tpu_torch.models.lm import CausalLM

    with np.load(path) as npz:
        tree = {k: npz[k] for k in npz.files}
    try:
        spec, state = lm_params_from_jax(tree, num_heads=num_heads)
    except ValueError as e:
        raise SystemExit(f"{flag} {path}: {e}")
    return CausalLM.from_state(spec, state, device)


if __name__ == "__main__":
    main()
