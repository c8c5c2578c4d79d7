#!/usr/bin/env python3
"""Time the population kernel (K2, ``csrc/popsim.cu``) on the card and read
its SASS, on qwen2.5-32b:prefill_32k (V = 707) against populations of P
designs (cell_read_latency scaled 0.5x-2x, as ``chip_smoke.py`` makes them).

    PYTHONPATH=src python3 tools/time_popsim.py [--P 512 4096 65536] [--lanes 0 2 32]
        [--graphs qwen qwen-1024 zeros] [--sources path/to/other/popsim.cu ...]
        [--variants no-zero-skip in-warp ...]

Builds the tree's kernel source, each source given (an earlier popsim.cu, say,
whose C entry takes no lanes argument) and each variant (the tree's source
with the text substitutions of ``VARIANTS``; the kernel stays bit-exact in
all of them), all with the tree's nvcc flags and one nvcc process each, all at
once.  For each it prints what ptxas reports (registers, spills) and the SASS
counts of each kernel function: all its instructions, and within its largest
loop (a backward branch's span, the vertex loop) the instructions, the
reciprocals (MUFU.RCP), division range checks (FCHK), calls (CALL, the
division's slow path), BSSY, shared loads (LDS), max/min (FMNMX) and
roundings (FRND).  Then one line per (source, graph, P, lanes): the device ms
a call (torch.profiler, the mean of 20 calls' launches, after a warm-up
call), designs per second, and whether the output equals the plain version
bit for bit.  Graphs: ``qwen`` (V = 707), ``qwen-1024`` (the same padded
with zero rows to its 1,024 bucket) and ``zeros`` (707 zero rows): zero
numerators show whether the division's slow path is taken.  Lanes: 0 is the
launcher's choice, others force the lanes a design (``popsim_kernel.LANES``).
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name -> (old, new) substitutions in csrc/popsim.cu; each old text must occur
VARIANTS = {
    # every division by '/', a zero numerator included (its range check takes the slow path)
    "no-zero-skip": [("  if (a != 0.f) return a / b;\n", "  return a / b;\n")],
    # a zero numerator divides 1 instead and its quotient is selected after: no branch around '/'
    "quot-select": [("  if (a != 0.f) return a / b;\n  return ", "  const float q = (a != 0.f ? a : 1.f) / b;\n  if (a != 0.f) return q;\n  return ")],
    # max and min as two NaN tests, fmaxf/fminf and a select (as before max.NaN.f32)
    "isnan-max": [('asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));',
                   'd = (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);'),
                  ('asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));',
                   'd = (isnan(a) || isnan(b)) ? nanf("") : fminf(a, b);')],
    # a design's lanes side by side in one warp (so its vertices' branches diverge)
    "in-warp": [("const int ds = threadIdx.x % kDesigns, j = threadIdx.x / kDesigns;",
                 "const int ds = threadIdx.x / L, j = threadIdx.x % L;")],
    # 256-row graph tiles; 6 blocks an SM (80 registers a thread); 256-thread blocks
    "tile-256": [("kTileRows = 128;", "kTileRows = 256;")],
    "min-blocks-6": [("kMinBlocks = 8;", "kMinBlocks = 6;")],
    "block-256": [("kBlock = 128;", "kBlock = 256;")],
}
OPS = ("MUFU.RCP", "FCHK", "CALL", "BSSY", "LDS", "FMNMX", "FRND")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def build(sources: dict[str, str]) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile each (tag -> source text) into its own library, all at once.
    Returns tag -> (library, nvcc/ptxas output)."""
    from repro_torch.kernels import runtime

    out = runtime.build_dir() / "time_popsim"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        src, lib = out / f"popsim-{tag}.cu", out / f"popsim-{tag}.so"
        src.write_text(text)
        cmd = [runtime.nvcc_path(), *runtime.flags("popsim"), "-o", str(lib), str(src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        built[tag] = (lib, log)
    return built


def sass_counts(lib: pathlib.Path) -> dict[str, dict]:
    """Kernel function -> its SASS counts: ``all`` instructions, and ``loop``,
    the counts within the largest backward branch's span."""
    from repro_torch.kernels import runtime

    bindir = pathlib.Path(runtime.nvcc_path()).parent
    sass = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    filt = shutil.which("cu++filt") or str(bindir / "cu++filt")
    funcs: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            if pathlib.Path(filt).exists():
                name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip() or name
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    result = {}
    for name, lines in funcs.items():
        insns, labels, pending = [], {}, []
        for line in lines:
            lm = _LABEL.match(line)
            if lm:
                pending.append(lm.group(1))
                continue
            m = _INSN.search(line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                insns.append((addr, m.group(2), m.group(3)))
        span = (0, -1)
        for addr, op, rest in insns:
            if not op.startswith("BRA"):
                continue
            t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", rest)
            target = labels.get(t.group(1)) if t and t.group(1) else (int(t.group(2), 16) if t else None)
            if target is not None and target < addr and addr - target > span[1] - span[0]:
                span = (target, addr)

        def count(sel):
            c = {"instructions": len(sel)}
            for op in OPS:
                c[op] = sum(1 for _, o, _ in sel if o == op or o.startswith(op + "."))
            return c

        result[name] = {"all": count(insns), "loop": count([i for i in insns if span[0] <= i[0] <= span[1]])}
    return result


def launcher(lib_path: pathlib.Path, text: str):
    """(run(graph, chw, lanes) -> out, whether the entry takes lanes), for the
    library built from the source ``text``."""
    import torch

    lib = ctypes.CDLL(str(lib_path))
    takes_lanes = re.search(r"popsim_launch\([^)]*\bint lanes\b", text) is not None
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = lib.popsim_launch
    fn.argtypes = [P_, P_, P_, I_, I_] + ([I_] if takes_lanes else []) + [P_]
    fn.restype = I_

    def run(gp, cp, lanes):
        out = torch.empty((cp.shape[0], 8), dtype=torch.float32, device=cp.device)
        args = [gp.data_ptr(), cp.data_ptr(), out.data_ptr(), gp.shape[0], cp.shape[0]]
        err = fn(*args, *([lanes] if takes_lanes else []), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"popsim launch failed with CUDA error {err}")
        return out

    return run, takes_lanes


def main() -> int:
    import torch

    from chip_smoke import device_ms
    from repro_torch.core import ArchParams, TechParams, specialize
    from repro_torch.kernels import ops, ref, runtime
    from repro_torch.kernels import popsim_kernel as pk
    from repro_torch.workloads import lm_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--P", type=int, nargs="+", default=[512, 4096, 65536])
    ap.add_argument("--lanes", type=int, nargs="+", default=[0])
    ap.add_argument("--graphs", nargs="+", default=["qwen"], choices=["qwen", "qwen-1024", "zeros"])
    ap.add_argument("--sources", nargs="*", default=[], help="other kernel sources to build and time")
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--no-time", action="store_true", help="print the build and SASS counts only")
    args = ap.parse_args()
    device = runtime.resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    tree = (runtime.CSRC / runtime.SOURCES["popsim"]).read_text()
    texts = {"tree": tree}
    for i, path in enumerate(args.sources):
        texts[f"source{i}"] = pathlib.Path(path).read_text()
    for name in args.variants:
        text = tree
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    label = {"tree": "tree", **{f"source{i}": p for i, p in enumerate(args.sources)},
             **{n: f"variant {n}" for n in args.variants}}
    built = build(texts)
    for tag, (lib, log) in built.items():
        print(f"== {label[tag]}")
        for line in log.splitlines():
            if re.search(r"registers|spill|Compiling entry", line):
                print(f"  ptxas: {line.strip()}")
        for fn, c in sass_counts(lib).items():
            print(f"  SASS {fn}: all {c['all']}; largest loop {c['loop']}")
    if args.no_time:
        return 0

    graphs = {}
    qwen = lm_cell("qwen2.5-32b", "prefill_32k", device=device)
    for g in args.graphs:
        graphs[g] = {"qwen": lambda: ops.pack_graph(qwen), "qwen-1024": lambda: ops.pack_graph(qwen.pad_to(1024)),
                     "zeros": lambda: torch.zeros(qwen.n_comp.shape[0], pk.GRAPH_COLS, device=device)}[g]()
    runs = {tag: launcher(lib, texts[tag]) for tag, (lib, _) in built.items()}
    for P in args.P:
        tech = TechParams.default(device)
        tech.cell_read_latency = tech.cell_read_latency * torch.linspace(0.5, 2.0, P, device=device)[:, None]
        cp = ops.pack_chw(specialize(tech, ArchParams.default(device)))
        for gname, gp in graphs.items():
            want = ref.popsim_reference(gp, cp)
            for tag, (run, takes_lanes) in runs.items():
                for lanes in (args.lanes if takes_lanes else [0]):
                    got = run(gp, cp, lanes)
                    exact = torch.equal(got, want)
                    ms, method = device_ms(lambda: run(gp, cp, lanes), 20, "popsim_kernel")
                    lanes_s = (f"lanes {lanes or 'auto'}" if takes_lanes else "lanes -")
                    print(f"{label[tag]} {gname} V={gp.shape[0]} P={P} {lanes_s}: {ms:.6f} ms ({method}), "
                          f"{P / ms * 1e3:.4e} designs/s, bit-exact {exact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
