#!/usr/bin/env python3
"""Time source variants of the flash-attention kernels on one GPU.

    python3 flash_variants.py [--dtype bf16|fp32] [NAME ...]
    python3 flash_variants.py --decode [NAME ...]

Each variant is ddp_tpu_torch/ops/csrc/flash_attn.cu (and the headers
beside it) with one design choice undone or one part removed (VARIANTS:
a named text edit, for the bf16 or the fp32 kernels). Every variant is
built into its own directory under ops/_build/variants/ (one nvcc each,
started together), loaded in place of the real library, and B1, B2 and
B3 in the chosen dtype (default bf16; the variants of that dtype unless
named) are timed at the training shape (B 8, T = S 2048, H 8, D 128,
causal) with chip_smoke's timer, twice in turns, beside the unedited
source ("base"). A "diagnostic" variant computes a wrong result on
purpose, to show what one part costs; the others must give base's bits
or differ from them by rounding only (exp2f, the fp32 chain lengths).
B2 and B3 run on the plain version's lse and delta', and each variant's
B1 out, B2 dq and B3 dk, dv are held against the plain version as phase
3b holds them ("err": relative norm error and the worst element's share
of its limit, under FLASH_TOL). Prints the card, one line per variant
and round, then one JSON line {variant: {"fwd_us": [...], "dq_us":
[...], "dkv_us": [...], "same": bool, "err": {...}}} ("same": the
outputs equal base's bit for bit), after each variant's ptxas registers
and spills.

``--decode`` does the same for the flash-decode kernels B4/B5
(flash_decode.cu, DECODE_VARIANTS: text edits and the wrapper's split
constants), timed at full width (S 8, H 8, Dh 128), every lane at L-1,
at L 256 and L 8192; each output's max error against the plain version
and its bits against base's.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# name -> (what it shows, dtype, diagnostic?, [(old, new), ...] edits of
# flash_attn.cu or a header beside it; each `old` must occur in one file)
VARIANTS = {
    "exp2f": ("exp2f (ex2 with denormal handling) instead of one MUFU.EX2",
              "bf16", False, [("sm90::exp2_ftz(", "exp2f(")]),
    "fwd_stages2": ("a 2-stage K/V ring in B1", "bf16", False,
                    [("kFwdStages = 3, kDkvStages = 2", "kFwdStages = 2, kDkvStages = 2")]),
    "dkv_stages3": ("a 3-stage Q/dO ring in B3", "bf16", False,
                    [("kFwdStages = 3, kDkvStages = 2", "kFwdStages = 3, kDkvStages = 3")]),
    "dq_stages2": ("a 2-stage K/V ring in B2", "bf16", False,
                   [("kDqStages = 3;", "kDqStages = 2;")]),
    "dq_stages4": ("a 4-stage K/V ring in B2", "bf16", False,
                   [("kDqStages = 3;", "kDqStages = 4;")]),
    "dq_bk128": ("128-key K/V tiles in B2 (S, dP and dQ: 192 registers a "
                 "thread) and a 2-stage ring (3 stages exceed 227 KB)",
                 "bf16", False,
                 [("kDqBQ = 128, kDqBK = 64;", "kDqBQ = 128, kDqBK = 128;"),
                  ("kDqStages = 3;", "kDqStages = 2;")]),
    "dq_one_cta": ("B2 not persistent: one CTA an item", "bf16", False,
                   [("const bool persistent = kernel != kDkv;",
                     "const bool persistent = kernel == kFwd;")]),
    "one_group": ("no head groups: every head's first tiles first, as a "
                  "plain (b*h, tile) grid runs", "bf16", False,
                  [("kL2GroupBytes = 16LL << 20", "kL2GroupBytes = 1LL << 40")]),
    "no_softmax": ("B1 without the softmax of tiles after the first "
                   "(products and pipeline only)", "bf16", True,
                   [("fwd_softmax(sc, m, l, corr, j * kFwdBK, t0, qw, cq, sl2, a);",
                     "corr[0] = corr[1] = 1.f;")]),
    "dq_no_ds": ("B2 without dS of tiles after the first (products and "
                 "pipeline only)", "bf16", True,
                 [("dq_scores(sc, dp, lse2, dl, j * kDqBK, t0, qw, cq, sl2, a);",
                   "(void)sc;")]),
    "no_pv": ("B1 without O += P.V", "bf16", True,
              [("mma_mn<DT>(o, pa[kk], v_prev, kFwdBK, kk);", "(void)v_prev;")]),
    "tf32_one_pass": ("one TF32 pass a product (big.big alone) in fp32 B1 "
                      "and B3", "fp32", True,
                      [("    mma(d, as, bb);\n    mma(d, ab, bs);\n", "")]),
    "tf32_stages1": ("a shallower ring in fp32 B1 and B3: one stage, each "
                     "tile loaded between two __syncthreads", "fp32", False,
                     [("kTfStages = 2;", "kTfStages = 1;")]),
    "tf32_one_chain": ("fp32 B1 and B3: O, dK and dV accumulated in one "
                       "mma chain over every key or query (the truncating "
                       "accumulation's drift)", "fp32", False,
                       [("tf32x3::mma3(acc, pb[kk], ps[kk], bb, bs);",
                         "tf32x3::mma3(o[n], pb[kk], ps[kk], bb, bs);"),
                        ("tf32x3::mma3(acc, gb[kk], gs[kk], bb, bs);",
                         "tf32x3::mma3(dq[n], gb[kk], gs[kk], bb, bs);"),
                        ("tf32x3::mma3(av, pb[kk], ps[kk], bb, bs);",
                         "tf32x3::mma3(dv[n], pb[kk], ps[kk], bb, bs);"),
                        ("tf32x3::mma3(ak, gb[kk], gs[kk], bb, bs);",
                         "tf32x3::mma3(dk[n], gb[kk], gs[kk], bb, bs);")]),
    "tf32_dq_bk64": ("64-key K/V tiles in fp32 B2, and a 1-stage ring in "
                     "all three (64-key tiles and 2 stages exceed 227 KB "
                     "at D 128)", "fp32", False,
                     [("kTfDqBQ = 128, kTfDqBK = 32;",
                       "kTfDqBQ = 128, kTfDqBK = 64;"),
                      ("kTfStages = 2;", "kTfStages = 1;")]),
    "tf32_groups": ("fp32 B1-B3 scheduled in head groups of <= 16 MB "
                    "streamed tiles, as the bf16 kernels are", "fp32", False,
                    [("    g.group = a.B * a.H;\n",
                      "    g.group = static_cast<int>(std::max<int64_t>(1, "
                      "std::min<int64_t>(a.B * a.H, kL2GroupBytes / (2LL * "
                      "(kernel == kDkv ? a.T : a.S) * a.D * 4))));\n")]),
}


# Variants whose tiles differ from the wrappers' TMA boxes: the rows
# ops/flash.SM90_ROWS must hand the kernel while they run.
SM90_ROWS = {"dq_bk128": {"flash_attn_dq": {"q": 128, "kv": 128}}}

# The flash-decode kernels B4/B5 (``--decode``): name -> (what it shows,
# [(old, new), ...] edits of flash_decode.cu, {name: value} set on
# ops/decode while the variant runs — the wrapper's split constants).
_FP32 = "kKeys = 2;\n    static constexpr int kStages = 3;"
_INT8 = "kKeys = 4;\n    static constexpr int kStages = 2;"
DECODE_VARIANTS = {
    "ring1": ("a 1-stage ring: each tile loaded between two __syncthreads",
              [(_FP32, _FP32[:-2] + "1;"), (_INT8, _INT8[:-2] + "1;")], {}),
    "fp32_ring2": ("a 2-stage ring in B4", [(_FP32, _FP32[:-2] + "2;")], {}),
    "int8_ring3": ("a 3-stage ring in B5", [(_INT8, _INT8[:-2] + "3;")], {}),
    "ring4": ("a 4-stage ring", [(_FP32, _FP32[:-2] + "4;"),
                                 (_INT8, _INT8[:-2] + "4;")], {}),
    "copy4": ("4-byte cp.async copies (scalar loads into the ring)",
              [("kCopyBytes = 16;", "kCopyBytes = 4;")], {}),
    "ctas2": ("chunks for ~2 CTAs per SM", [],
              {"SPLIT_CTAS_PER_SM": {"fp32": 2, "int8": 2}}),
    "ctas4": ("chunks for ~4 CTAs per SM", [],
              {"SPLIT_CTAS_PER_SM": {"fp32": 4, "int8": 4}}),
    "ctas8": ("chunks for ~8 CTAs per SM", [],
              {"SPLIT_CTAS_PER_SM": {"fp32": 8, "int8": 8}}),
    "ctas16": ("chunks for ~16 CTAs per SM", [],
               {"SPLIT_CTAS_PER_SM": {"fp32": 16, "int8": 16}}),
    "no_split": ("one chunk a (lane, head): no split", [],
                 {"MIN_CHUNK_BYTES": 1 << 40}),
    "min_chunk_0": ("no least chunk: chunks of one tile at L 256", [],
                    {"MIN_CHUNK_BYTES": 0}),
    "min_chunk_32k": ("chunks of at least 32 KB of K and V", [],
                      {"MIN_CHUNK_BYTES": 32 * 1024}),
    "min_chunk_128k": ("chunks of at least 128 KB of K and V", [],
                       {"MIN_CHUNK_BYTES": 128 * 1024}),
    "fp32_keys4": ("B4 tiles of 4 keys a row group (64 keys at Dh 128)",
                   [(_FP32, "kKeys = 4;" + _FP32[10:])],
                   {"KEYS_PER_ROW_GROUP": {"fp32": 4, "int8": 4}}),
    "int8_keys8": ("B5 tiles of 8 keys a row group (128 keys at Dh 128)",
                   [(_INT8, "kKeys = 8;" + _INT8[10:])],
                   {"KEYS_PER_ROW_GROUP": {"fp32": 2, "int8": 8}}),
}


def build(names, source="flash_attn.cu", edits=lambda n: VARIANTS[n][3]) -> dict[str, Path]:
    """Each variant's library (``edits(name)`` applied to ``source`` and
    the headers beside it), built in parallel → {name: path}."""
    from ddp_tpu_torch.ops import _build

    files = [_build.CSRC / source, *_build.CSRC.glob("*.cuh")]
    sources = {f.name: f.read_text() for f in files}
    root = _build.BUILD_DIR / "variants" / Path(source).stem
    procs = {}
    for name in names:
        texts = dict(sources)
        for old, new in ([] if name == "base" else edits(name)):
            hits = [f for f, text in texts.items() if old in text]
            if len(hits) != 1:
                raise ValueError(f"variant {name}: {old!r} is in {hits}")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        path.with_suffix(".log").write_text(log)  # ptxas's report
        libs[name] = path
    return libs


def decode_main(names) -> int:
    """B4 and B5 under each decode variant (default: all), at full width,
    every lane at L-1, L 256 and L 8192: two rounds in turns with base,
    each output's bits against base's and its max error against the
    plain version, and the kernel's median time (µs)."""
    import torch

    from ddp_tpu_torch.ops import _build
    from ddp_tpu_torch.ops import decode as dec

    names = ["base"] + (names or list(DECODE_VARIANTS))
    libs = build(names, "flash_decode.cu", lambda n: DECODE_VARIANTS[n][1])
    for name, path in libs.items():
        cs.log(f"[variants] {name} ptxas: " + ", ".join(
            f"{cs.decode_kernel_name(r['kernel'])} {r['registers']} "
            f"registers, spill {r['spill_stores']}/{r['spill_loads']} bytes"
            for r in _build.parse_ptxas(path.with_suffix(".log").read_text())))
    _, S, H, H_kv, Dh, _ = cs.DECODE_SHAPES[0]
    cases = {}
    for kv in ("fp32", "int8"):
        for L in cs.DECODE_TIMED_L:
            args = cs._inputs(torch, S, H, H_kv, Dh, L, [L - 1] * S,
                              kv == "int8", seed=99)
            cases[f"{kv} L={L}"] = (args, dec.decode_attention_reference(*args))
    real_load = _build.load
    keys = {"fp32": torch.float32, "int8": torch.int8}
    saved = {a: getattr(dec, a) for a in ("SPLIT_CTAS_PER_SM",
                                          "KEYS_PER_ROW_GROUP",
                                          "MIN_CHUNK_BYTES")}
    results = {n: {"us": {c: [] for c in cases}, "same": None, "err": {}}
               for n in names}
    base = {}
    try:
        for rnd in range(2):
            for name in names:
                _build.load = lambda source, p=libs[name]: ctypes.CDLL(str(p))
                dec._lib.cache_clear()
                for a, val in saved.items():
                    setattr(dec, a, val)
                for a, val in ({} if name == "base"
                               else DECODE_VARIANTS[name][2]).items():
                    if a in ("KEYS_PER_ROW_GROUP", "SPLIT_CTAS_PER_SM"):
                        val = {keys[k]: n for k, n in val.items()}
                    setattr(dec, a, val)
                r = results[name]
                same = True
                for c, (args, ref) in cases.items():
                    got = dec.flash_decode_attention(*args)
                    torch.cuda.synchronize()
                    if name == "base":
                        base[c] = got
                    same = same and torch.equal(got, base[c])
                    r["err"][c] = float((got - ref).abs().max())
                    r["us"][c].append(round(cs._median_ms(
                        torch, lambda: dec.flash_decode_attention(*args),
                        n=20, reps=5) * 1e3, 2))
                r["same"] = same
                what = "base" if name == "base" else DECODE_VARIANTS[name][0]
                cs.log(f"[variants] decode round {rnd} {name}: " + ", ".join(
                    f"{c} {r['us'][c][-1]} us" for c in cases)
                    + f"; bits as base: {same}; max err vs plain "
                    f"{max(r['err'].values()):.2e} ({what})")
    finally:
        _build.load = real_load
        dec._lib.cache_clear()
        for a, val in saved.items():
            setattr(dec, a, val)
    cs.log(cs.card_line())
    print(json.dumps(results), flush=True)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    if "--decode" in argv:
        return decode_main([a for a in argv if a != "--decode"])
    from ddp_tpu_torch.ops import _build
    from ddp_tpu_torch.ops import flash as fl

    dname = "bf16"
    if "--dtype" in argv:
        i = argv.index("--dtype")
        dname, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    names = ["base"] + (argv or [n for n, v in VARIANTS.items()
                                 if v[1] == dname])
    libs = build(names)
    for name, path in libs.items():
        cs.log(f"[variants] {name} ptxas: " + ", ".join(
            f"{r['kernel'].split('_flash_attn_cu_')[-1][:24]} {r['registers']} "
            f"registers, spill {r['spill_stores']}/{r['spill_loads']} bytes"
            for r in _build.parse_ptxas(path.with_suffix(".log").read_text())
            if any(k in r["kernel"] for k in cs.REGISTER_KERNELS)))
    B, T, S, H, D, causal = cs.TRAIN_SHAPE
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
    q, k, v, dout, _ = cs._flash_inputs(torch, B, T, S, H, D, dtype, seed=99)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    ref_out, lse = fl.attention_with_lse_reference(qf, kf, vf, causal)
    delta = fl.backward_delta(ref_out, df)
    ref = {"out": ref_out,
           "dq": fl.flash_dq_reference(qf, kf, vf, df, lse, delta, causal)}
    ref["dk"], ref["dv"] = fl.flash_dkv_reference(qf, kf, vf, df, lse, delta,
                                                  causal)
    del qf, kf, vf, df, ref_out
    real_load = _build.load
    base_rows = dict(fl.SM90_ROWS)
    keys = {"fwd": "flash_attn_fwd", "dq": "flash_attn_dq",
            "dkv": "flash_attn_dkv"}
    results = {n: {**{f"{k}_us": [] for k in keys}, "same": None, "err": {}}
               for n in names}
    base = None
    try:
        for rnd in range(2):
            for name in names:
                _build.load = lambda source, p=libs[name]: ctypes.CDLL(str(p))
                fl._lib.cache_clear()
                fl.SM90_ROWS.update(base_rows)
                fl.SM90_ROWS.update(SM90_ROWS.get(name, {}))
                got = dict(zip(("out", "lse"), fl.flash_forward(q, k, v, causal)))
                got["dq"] = fl.flash_dq(q, k, v, dout, lse, delta, causal)
                got["dk"], got["dv"] = fl.flash_dkv(q, k, v, dout, lse, delta,
                                                    causal)
                if name == "base":
                    base = got
                same = all(torch.equal(got[n], base[n]) for n in got)
                r = results[name]
                for what, want in ref.items():
                    r["err"][what] = cs._compare(
                        torch, got[what], want,
                        cs.FLASH_TOL[dname])[1].split(" (")[0]
                del got
                calls = cs._kernel_calls(fl, q, k, v, dout, lse, delta, causal)
                us = {}
                for key, kname in keys.items():
                    us[key] = round(cs._median_ms(torch, calls[kname], n=10,
                                                  reps=5) * 1e3, 1)
                    r[f"{key}_us"].append(us[key])
                r["same"] = same
                what = "base" if name == "base" else VARIANTS[name][0] + (
                    "; diagnostic, wrong on purpose" if VARIANTS[name][2] else "")
                cs.log(f"[variants] {dname} round {rnd} {name}: B1 {us['fwd']} us, "
                       f"B2 {us['dq']} us, B3 {us['dkv']} us, bits as base: "
                       f"{same}, vs plain {r['err']} ({what})")
    finally:
        _build.load = real_load
        fl._lib.cache_clear()
        fl.SM90_ROWS.update(base_rows)
    cs.log(cs.card_line())
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
