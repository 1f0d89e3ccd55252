#!/usr/bin/env python3
"""Time source variants of the flash-attention kernels on one GPU.

    python3 flash_variants.py [NAME ...]

Each variant is ddp_tpu_torch/ops/csrc/flash_attn.cu with one design
choice undone or one part removed (VARIANTS: a named text edit). Every
variant is built into its own directory under ops/_build/variants/ (one
nvcc each, started together), loaded in place of the real library, and
B1 and B3 (bf16) are timed at the training shape (B 8, T = S 2048, H 8,
D 128, causal) with chip_smoke's timer, twice in turns, beside the
unedited source ("base"). A "diagnostic" variant computes a wrong result
on purpose, to show what one part costs; the others must give base's
bits or differ from them by rounding only (exp2f). Prints the card, one
line per variant and round, then one JSON line {variant: {"fwd_us":
[...], "dkv_us": [...], "same": bool}} ("same": B1's and B3's outputs
equal base's bit for bit).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# name -> (what it shows, diagnostic?, [(old, new), ...] edits of the source)
VARIANTS = {
    "exp2f": ("exp2f (ex2 with denormal handling) instead of one MUFU.EX2",
              False, [("sm90::exp2_ftz(", "exp2f(")]),
    "fwd_stages2": ("a 2-stage K/V ring in B1", False,
                    [("kFwdStages = 3, kDkvStages = 2", "kFwdStages = 2, kDkvStages = 2")]),
    "dkv_stages3": ("a 3-stage Q/dO ring in B3", False,
                    [("kFwdStages = 3, kDkvStages = 2", "kFwdStages = 3, kDkvStages = 3")]),
    "one_group": ("no head groups: every head's first tiles first, as a "
                  "plain (b*h, tile) grid runs", False,
                  [("kL2GroupBytes = 16LL << 20", "kL2GroupBytes = 1LL << 40")]),
    "no_softmax": ("B1 without the softmax of tiles after the first "
                   "(products and pipeline only)", True,
                   [("fwd_softmax(sc, m, l, corr, j * kFwdBK, t0, qw, cq, sl2, a);",
                     "corr[0] = corr[1] = 1.f;")]),
    "no_pv": ("B1 without O += P.V", True,
              [("mma_mn<DT>(o, pa[kk], v_prev, kFwdBK, kk);", "(void)v_prev;")]),
}


def build(names) -> dict[str, Path]:
    """Each variant's library, built in parallel → {name: path}."""
    from ddp_tpu_torch.ops import _build

    source = (_build.CSRC / "flash_attn.cu").read_text()
    root = _build.BUILD_DIR / "variants"
    procs = {}
    for name in names:
        text = source
        for old, new in ([] if name == "base" else VARIANTS[name][2]):
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attn.cu").write_text(text)
        for header in _build.CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        libs[name] = path
    return libs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from ddp_tpu_torch.ops import _build
    from ddp_tpu_torch.ops import flash as fl

    names = ["base"] + (argv or list(VARIANTS))
    libs = build(names)
    B, T, S, H, D, causal = cs.TRAIN_SHAPE
    q, k, v, dout, _ = cs._flash_inputs(torch, B, T, S, H, D, torch.bfloat16,
                                        seed=99)
    real_load = _build.load
    results = {n: {"fwd_us": [], "dkv_us": [], "same": None} for n in names}
    base = None
    try:
        for rnd in range(2):
            for name in names:
                _build.load = lambda source, p=libs[name]: ctypes.CDLL(str(p))
                fl._lib.cache_clear()
                out, lse = fl.flash_forward(q, k, v, causal)
                delta = fl.backward_delta(out, dout)
                dk, dv = fl.flash_dkv(q, k, v, dout, lse, delta, causal)
                if name == "base":
                    base = (out, lse, dk, dv)
                same = all(torch.equal(a, b) for a, b in
                           zip((out, lse, dk, dv), base))
                calls = cs._kernel_calls(fl, q, k, v, dout, lse, delta, causal)
                fwd = cs._median_ms(torch, calls["flash_attn_fwd"], n=10, reps=5)
                dkv = cs._median_ms(torch, calls["flash_attn_dkv"], n=10, reps=5)
                r = results[name]
                r["fwd_us"].append(round(fwd * 1e3, 1))
                r["dkv_us"].append(round(dkv * 1e3, 1))
                r["same"] = same
                what = "base" if name == "base" else VARIANTS[name][0] + (
                    "; diagnostic, wrong on purpose" if VARIANTS[name][1] else "")
                cs.log(f"[variants] round {rnd} {name}: B1 {fwd * 1e3:.1f} us, "
                       f"B3 {dkv * 1e3:.1f} us, bits as base: {same} ({what})")
    finally:
        _build.load = real_load
        fl._lib.cache_clear()
    cs.log(cs.card_line())
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
