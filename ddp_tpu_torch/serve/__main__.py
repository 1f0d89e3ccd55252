"""Serving CLI: stand up the continuous-batching engine behind HTTP.

    python -m ddp_tpu_torch.serve --init_demo --vocab_size 8192 \\
        --seq_len 256 --d_model 1024 --depth 8 --num_heads 8 \\
        --slots 8 --kv_dtype int8 --port 8000
    curl -s localhost:8000/generate -d \\
        '{"prompt_tokens": [1, 2, 3], "max_new_tokens": 32}'

``--init_demo`` serves seeded random weights (``--seed``); ``--params_npz``
serves a JAX causal-LM parameter tree saved as a flat ``/``-keyed
``.npz`` (``numpy.savez(path, **{"/".join(keys): leaf})``), mapped by
``interop/jax_params.py``. Runs on the GPU, where decode attention always
goes through the CUDA flash-decode kernel, unless ``--device cpu`` is
given (the plain versions run there). Prints one JSON line when it
serves, then serves until SIGTERM or Ctrl-C.
"""

from __future__ import annotations

import argparse
import json
import signal
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
    p.add_argument("--seed", type=int, default=0,
                   help="--init_demo weight seed")
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--seq_len", type=int, default=128,
                   help="--init_demo context length (total_len)")
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4,
                   help="attention heads (also needed for --params_npz: "
                   "shapes do not carry it)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prefill_len", type=int, default=None,
                   help="longest admissible prompt (default total_len/2)")
    p.add_argument("--kv_dtype", default="fp32", choices=["fp32", "int8"])
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    from ddp_tpu_torch.models.lm import CausalLM, LMSpec, init_lm
    from ddp_tpu_torch.serve.engine import ServeEngine
    from ddp_tpu_torch.serve.server import LMServer
    from ddp_tpu_torch.utils.metrics import MetricsWriter

    if args.params_npz:
        from ddp_tpu_torch.interop.jax_params import lm_params_from_jax

        with np.load(args.params_npz) as npz:
            tree = {k: npz[k] for k in npz.files}
        try:
            spec, state = lm_params_from_jax(tree, num_heads=args.num_heads)
        except ValueError as e:
            raise SystemExit(f"--params_npz {args.params_npz}: {e}")
        model = CausalLM.from_state(spec, state, args.device)
    else:
        spec = LMSpec(
            vocab_size=args.vocab_size, total_len=args.seq_len,
            d_model=args.d_model, depth=args.depth,
            num_heads=args.num_heads,
        )
        model = init_lm(spec, seed=args.seed, device=args.device)
    metrics = MetricsWriter(args.metrics_file)
    engine = ServeEngine(
        model,
        slots=args.slots,
        prefill_len=args.prefill_len,
        metrics=metrics,
        kv_dtype=args.kv_dtype,
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        with LMServer(engine, host=args.host, port=args.port) as server:
            print(json.dumps({
                "serving": server.url,
                "device": str(engine.device),
                "spec": spec._asdict(),
                "slots": engine.num_slots,
                "prefill_len": engine.prefill_len,
                "buckets": engine.buckets,
                "decode_attn": engine.decode_attn,
                "kv_dtype": engine.kv_dtype,
                "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
            }), flush=True)
            try:
                stop.wait()
            except KeyboardInterrupt:
                pass
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
