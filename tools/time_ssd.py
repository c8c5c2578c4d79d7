#!/usr/bin/env python3
"""Time the SSD chunk scan's kernels (K4, ``csrc/ssd.cu``) on the card at
zamba2-1.2b's shapes, x [1,S,64,64] bf16, N = 64: for each number of heads a
block of the chunk kernels may take, and for variants of the source.

    PYTHONPATH=src python3 tools/time_ssd.py [--prompts 4096 1000 257 64] [--heads 1 2 4 8]
                                             [--variants no-exp no-carry ...]

Prints the card's name and power limit, then one line per (variant, S, heads
a block): the device time of each of the kernels a call (torch.profiler, the mean
of 20 calls' launches) and their sum.  The wrapper's own choice of
heads a block (``ssd.heads_per_block``) is marked.  A variant is the kernel
source with the text substitutions of ``VARIANTS`` applied, built with the
same nvcc flags; most compute a wrong result and serve only to show where the
time goes.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name -> (old, new) substitutions in csrc/ssd.cu; each old text must occur
VARIANTS = {
    # the outputs kernel without the exponentials of its scores (wrong output)
    "no-exp": [("exp2f((cm[i].x - cm[j].x) + (cm[i].y - cm[j].y))", "1.0f")],
    # the outputs kernel without its scores (wrong output)
    "no-scores": [("for (int q = 0; q < 4; ++q) {\n      const int j = 4 * cx + q;",
                   "for (int q = 0; q < 0; ++q) {\n      const int j = 4 * cx + q;")],
    # the outputs kernel without C B^T (wrong output)
    "no-cb": [("for (int n = 0; n < NP; ++n) {\n    const float4 v = ld4(bt",
               "for (int n = 0; n < 0; ++n) {\n    const float4 v = ld4(bt")],
    # the outputs kernel without C S_{c-1} (wrong output)
    "no-carry": [("for (int n = 0; n < NP; ++n) {\n        const float4 v = ld4(ss",
                  "for (int n = 0; n < 0; ++n) {\n        const float4 v = ld4(ss")],
    # the outputs kernel without scores x (wrong output)
    "no-triangle": [("for (int j = 0; j < ja_end; ++j)", "for (int j = 0; j < 0; ++j)"),
                    ("for (int j = ja_end; j < jb_end; ++j)", "for (int j = 0; j < 0; ++j)")],
    # the outputs kernel without its loads of x and of the entering state (wrong output)
    "no-x-loads": [("if (j < nl && p < P) r = raw8(", "if (j < 0) r = raw8("),
                   ("copy_batched<8>(NP * PP / 4, tid", "copy_batched<8>(0, tid")],
    # the outputs kernel without its stores of y (wrong output)
    "no-y-stores": [("if (iu + r < nl) store_cols", "if (iu + r < 0) store_cols"),
                    ("if (id + r < nl) store_cols", "if (id + r < 0) store_cols")],
    # the chunk-states kernel without its product (wrong output)
    "no-states-product": [("for (int j = 0; j < kChunk; ++j) {\n          const float* a = bs",
                           "for (int j = 0; j < 0; ++j) {\n          const float* a = bs")],
    # the pass's loads of dS not marked streaming (evict first)
    "pass-plain-loads": [("v[u] = __ldcs(st + (c0 + u) * step);", "v[u] = st[(c0 + u) * step];")],
    # the outputs kernel's loads of the entering state, its stores of y, and
    # both kernels' loads of x, marked streaming (evict first)
    "state-ldcs": [("[&](int e) { return src[e]; }", "[&](int e) { return __ldcs(src + e); }")],
    "y-stcs": [("*reinterpret_cast<uint2*>(p) = u;", "__stcs(reinterpret_cast<uint2*>(p), u);")],
    "x-ldcs": [("return *reinterpret_cast<const uint4*>(p); }", "return __ldcs(reinterpret_cast<const uint4*>(p)); }")],
    # the pass with 8 chunks' loads in flight, or 128 threads a block
    "pass-depth-8": [("kPassDepth = 16;", "kPassDepth = 8;")],
    "pass-128-threads": [("kPassThreads = 256;", "kPassThreads = 128;")],
}


def build_variant(name: str) -> pathlib.Path:
    from repro_torch.kernels import runtime

    text = (runtime.CSRC / runtime.SOURCES["ssd_chunk_scan"]).read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found: {old!r}")
        text = text.replace(old, new)
    out = runtime.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"ssd-{name}.cu", out / f"ssd-{name}.so"
    src.write_text(text)
    subprocess.run([runtime.nvcc_path(), *runtime.flags("ssd_chunk_scan"), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    import torch

    from chip_smoke import kernel_split_ms, ssd_draw
    from repro_torch.kernels import runtime, ssd

    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, nargs="+", default=[4096, 1000, 257, 64])
    ap.add_argument("--heads", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    device = runtime.resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {"kernel": runtime.library("ssd_chunk_scan")}
    for name in args.variants:
        libs[name] = ctypes.CDLL(str(build_variant(name)))
        runtime._bind("ssd_chunk_scan", libs[name])
    gen = torch.Generator("cuda").manual_seed(0)
    choose = ssd.heads_per_block
    try:
        for S in args.prompts:
            x, dt, A, Bm, Cm = ssd_draw(lambda *s: torch.randn(*s, generator=gen, device=device), S, torch.bfloat16)
            for name, lib in libs.items():
                runtime._LIBS["ssd_chunk_scan"] = lib
                for hpb in args.heads:
                    ssd.heads_per_block = lambda *a, k=hpb: k  # noqa: E731
                    split = kernel_split_ms(lambda: ssd.ssd_chunk_scan_op(x, dt, A, Bm, Cm), 20,
                                            r"(ssd_\w+_kernel)")
                    mark = "  (the wrapper's choice)" if hpb == choose(1, S, 64) else ""
                    print(f"{name} S={S} heads a block {hpb}: "
                          + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
                          + f"; sum {sum(split.values()):.6f} ms{mark}")
    finally:
        ssd.heads_per_block = choose
        runtime._LIBS["ssd_chunk_scan"] = libs["kernel"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
