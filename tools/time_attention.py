#!/usr/bin/env python3
"""Time one of K3's two attention kernels on the card: the float32-pipe kernel
(``--kernel flash_attention``, ``csrc/flash_attention.cu``, the default) or the
bf16 tensor-core kernel (``--kernel flash_attention_sm90``,
``csrc/flash_attention_sm90.cu``), at the shapes of chip_smoke.py's attention
records, beside the plain version and ``F.scaled_dot_product_attention`` (SDPA,
a yardstick the port never calls), and other sources of the kernel with the
same C entry built with the same flags, in the same process (for example the
parent commit's).

    PYTHONPATH=src python3 tools/time_attention.py [--kernel flash_attention_sm90]
        [--shapes f32:32:32:4096:64 ...] [--sources other.cu ...] [--variants no-qk no-pv ...]

A shape is dtype:Hq:Hkv:Sq:D (batch 1, causal, Skv = Sq), or
dtype:Hq:Hkv:Sq:Skv:D:causal with causal 0 or 1.  Prints the card's name and
power limit, ptxas's report for each build (registers, spills), then one line
per shape and source: the device time of a call (torch.profiler, the mean of 10
launches), the max abs error against the plain version and, in float32, each
one's max abs error against a float64 oracle; and the plain version's and
SDPA's device times (CUDA events around calls queued behind a spin kernel,
``chip_smoke.queued_ms``).  A source that refuses a shape (its C entry returns an
error) is reported as such.  A variant is this tree's source with the text
substitutions of ``VARIANTS`` applied; most compute a wrong result and serve
only to show where the time goes.  Needs a CUDA device and nvcc.
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

SHAPES = {"flash_attention": ["f32:32:32:4096:64", "f32:32:32:4096:128", "bf16:64:8:4096:112"],
          "flash_attention_sm90": ["bf16:32:32:4096:64", "bf16:32:8:4096:128", "bf16:64:8:4096:112"]}
# name -> (old, new) substitutions in the kernel's source; each old text must occur
VARIANTS_SM90 = {
    # O += P V at D = 112 as m64n128k16 (acc[64]): V's zero-filled columns 112-127
    # give zero output columns, which the epilogue never writes (1/8 more P V work)
    "pv-n128": [("static constexpr int kPV = D; ", "static constexpr int kPV = D == 112 ? 128 : D; ")],
}
VARIANTS = {
    # without S = Q K^T (wrong output)
    "no-qk": [("for (int d = 0; d < nd; d += 4) {", "for (int d = 0; d < 0; d += 4) {")],
    # without O += P V (wrong output)
    "no-pv": [("for (int kk = 0; kk < kBN; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")],
    # without the softmax's exponentials and shuffles (wrong output)
    "no-softmax": [("const float alpha = ex2(m[hh][e] - m_new);", "const float alpha = 1.0f;"),
                   ("const float p = ex2(s[hh][e][j] - m_new);", "const float p = s[hh][e][j];"),
                   ("for (int w = kTc / 2; w >= 1; w >>= 1) mt = fmaxf(",
                    "for (int w = 0; w >= 1; w >>= 1) mt = fmaxf(")],
    # 96-key tiles at width cap 128 (8 x 6 scores a thread), not 64
    "cap128-96-keys": [("kTr = 16, kTc = 16, kBN = 64, kMinBlocks = 1;", "kTr = 16, kTc = 16, kBN = 96, kMinBlocks = 1;")],
    # S = Q K^T without its loads of Q, or of K (wrong output)
    "qk-no-q-loads": [("qf[hh][e] = *reinterpret_cast<const float4*>(qs + (hh * kBM / 2 + tr * 4 + e) * kLd + d);",
                       "qf[hh][e] = make_float4(e, hh, d, 1.0f);")],
    "qk-no-k-loads": [("const float4 kf = *reinterpret_cast<const float4*>(ks + (tc + kTc * j) * kLd + d);",
                       "const float4 kf = make_float4(j, d, 1.0f, 2.0f);")],
}
# SASS opcodes counted in each kernel instance
OPCODES = ("FFMA", "LDS", "LD", "LDL", "STL", "LDGSTS", "SHFL", "MUFU", "BAR", "HGMMA", "UTMALDG")


def ptxas_report(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "Compiling" in ln]


def sass_counts(lib: pathlib.Path) -> list[str]:
    """One line per kernel instance in ``lib``: how many of each of ``OPCODES``
    its SASS holds (static counts, not executed ones)."""
    import re

    from repro_torch.kernels import runtime

    cuobjdump = pathlib.Path(runtime.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    lines = []
    for part in sass.split("Function : ")[1:]:
        name = re.search(r"flash_attention\w*?_kernel\w*?(I.*?)EE", part.split("\n", 1)[0])
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", part, re.M)
        counts = {op: sum(1 for o in ops if o == op) for op in OPCODES}
        lines.append(f"{name.group(1) if name else part[:40]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return lines


def variant_source(kernel: str, name: str) -> pathlib.Path:
    from repro_torch.kernels import runtime

    text = (runtime.CSRC / runtime.SOURCES[kernel]).read_text()
    for old, new in (VARIANTS_SM90 if kernel == "flash_attention_sm90" else VARIANTS)[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found: {old!r}")
        text = text.replace(old, new)
    out = runtime.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{kernel}-{name}.cu"
    src.write_text(text)
    return src


def build_sources(kernel: str, sources: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    """Build each source with the kernel's flags, all nvcc processes at once."""
    from repro_torch.kernels import runtime

    out = runtime.build_dir() / "sources"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, path) in enumerate(sources.items()):
        lib = out / f"{kernel}-{i}.so"
        cmd = [runtime.nvcc_path(), *runtime.flags(kernel), "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for ln in ptxas_report(log) + sass_counts(lib):
            print(f"  {name}: {ln}")
        libs[name] = ctypes.CDLL(str(lib))
        runtime._bind(kernel, libs[name])
    return libs


def oracle64(q, k, v, causal: bool = True):
    """Attention in float64: the reference's mask and softmax, no rounding to float32."""
    import torch

    group = q.shape[1] // k.shape[1]
    kd, vd = (x.double().repeat_interleave(group, 1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kd) * q.shape[-1] ** -0.5
    Sq, Skv = q.shape[2], k.shape[2]
    if causal:
        s = s.masked_fill(~torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(Skv - Sq), -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vd)


def sdpa(q, k, v, causal: bool = True):
    """SDPA on the same inputs, grouped heads passed as they are where this
    torch takes ``enable_gqa``; None where SDPA's mask is not the kernel's
    (causal with Sq != Skv: SDPA's is prefix-causal, the kernel's suffix-causal)."""
    import torch.nn.functional as F

    if causal and q.shape[2] != k.shape[2]:
        return None
    if q.shape[1] == k.shape[1]:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    try:
        F.scaled_dot_product_attention(q[:, :, :1], k[:, :, :1], v[:, :, :1], is_causal=causal, enable_gqa=True)
    except TypeError:
        return None
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def parse_shape(shape: str) -> tuple:
    """dtype:Hq:Hkv:S:D or dtype:Hq:Hkv:Sq:Skv:D:causal -> (dtype, Hq, Hkv, Sq, Skv, D, causal)."""
    import torch

    dt, *rest = shape.split(":")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    if len(rest) == 4:
        Hq, Hkv, S, D = map(int, rest)
        return dtype, Hq, Hkv, S, S, D, True
    Hq, Hkv, Sq, Skv, D, causal = map(int, rest)
    return dtype, Hq, Hkv, Sq, Skv, D, bool(causal)


def main() -> int:
    import torch

    from chip_smoke import device_ms, queued_ms
    from repro_torch.kernels import ref, runtime

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="flash_attention", choices=("flash_attention", "flash_attention_sm90"))
    ap.add_argument("--shapes", nargs="+")
    ap.add_argument("--sources", nargs="*", default=[], type=pathlib.Path)
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted({*VARIANTS, *VARIANTS_SM90}))
    ap.add_argument("--sass", type=pathlib.Path, help="write the kernel's SASS to this file")
    args = ap.parse_args()
    kernel = args.kernel
    device = runtime.resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {"kernel": runtime.library(kernel)}
    print(f"  {runtime.SOURCES[kernel]} built in {runtime.BUILD_SECONDS.get(kernel, 0.0):.1f} s")
    for ln in ptxas_report(runtime.BUILD_LOG.get(kernel, "")):
        print(f"  kernel: {ln}")
    for ln in sass_counts(runtime.build_all()[kernel]):
        print(f"  kernel: {ln}")
    if args.sass:
        cuobjdump = pathlib.Path(runtime.nvcc_path()).with_name("cuobjdump")
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(subprocess.run([str(cuobjdump), "-sass", str(runtime.build_all()[kernel])],
                                            capture_output=True, text=True, check=True).stdout)
    libs.update(build_sources(kernel, {**{str(p): p for p in args.sources},
                                       **{n: variant_source(kernel, n) for n in args.variants}}))
    gen = torch.Generator("cuda").manual_seed(0)
    for shape in args.shapes or SHAPES[kernel]:
        dtype, Hq, Hkv, Sq, Skv, D, causal = parse_shape(shape)
        q = torch.randn(1, Hq, Sq, D, generator=gen, device=device).to(dtype)
        k, v = (torch.randn(1, Hkv, Skv, D, generator=gen, device=device).to(dtype) for _ in range(2))
        want = ref.reference_attention(q, k, v, causal=causal)
        o64 = oracle64(q, k, v, causal) if dtype == torch.float32 else None
        plain_ms = queued_ms(lambda: ref.reference_attention(q, k, v, causal=causal), 3)
        lib_call = sdpa(q, k, v, causal)
        lib_ms = f"{queued_ms(lib_call, 10):.6f}" if lib_call is not None else "not measured"
        plain64 = f", plain vs float64 {float((want.double() - o64).abs().max()):.3g}" if o64 is not None else ""
        print(f"{shape}: plain {plain_ms:.6f} ms; SDPA {lib_ms} ms{plain64}")
        out = torch.empty_like(q)
        stream = runtime.stream_handle(q)
        for name, lib in libs.items():
            def call(lib=lib):
                a = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, Hq, Hkv, Sq, Skv, D, int(causal),
                     D ** -0.5)
                if kernel == "flash_attention_sm90":
                    return lib.flash_attention_sm90_launch(*a, stream)
                return lib.flash_attention_launch(*a, int(dtype == torch.bfloat16), stream)
            out.fill_(float("nan"))
            err = call()
            torch.cuda.synchronize()
            if err:
                print(f"  {name}: refuses the shape (CUDA error {err})")
                continue
            e = float((out.float() - want.float()).abs().max())
            rows = float(((out.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)).max())
            e64 = f", vs float64 {float((out.double() - o64).abs().max()):.3g}" if o64 is not None else ""
            ms, how = device_ms(call, 10, f"{kernel}_kernel")
            for _ in range(max(1, int(400 / ms))):  # ~0.4 s of launches, the clocks read while they run
                call()
            clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                                    capture_output=True, text=True, check=True).stdout.strip()
            torch.cuda.synchronize()
            print(f"  {name}: {ms:.6f} ms ({how}); max abs err vs plain {e:.3g}, max row err {rows:.3g} of the "
                  f"row's norm{e64}; under load {clocks}")
        del q, k, v, want, o64, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
