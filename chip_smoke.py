#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DRAGON on one GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment — torch, CUDA and nvcc versions, the card's name and power limit;
2. build — compile every kernel under src/repro_torch/kernels/csrc with nvcc
   for sm_90a (one process per source, in parallel) and check the binaries
   hold sm_90a code;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   on inputs from torch.Generator("cuda").manual_seed(0), at the shapes the
   main path gives it; each one's device time per launch (torch.profiler over
   many launches) and its time per call with the host path (CUDA events);
4. main path, with the launch counts set to 0 just before and read just after:
   a. simulate the 16 workloads of results/bench/sim_speed.json at the default
      design, each padded to its vertex bucket (next power of two, >= 32),
      with the default MapperCfg(), and hold cycles against ``cycles_dsim``;
   b. optimize 20 DOpt steps on the stack of the 5 LM cells (V = 1024) and
      hold the history against the reference package's (constants below);
   c. 3 steps on the 11 classic workloads (bucket 256) with scan_impl="ref"
      and with the default, which must agree;
   d. evaluate a population of 65,536 designs on qwen2.5-32b:prefill_32k and
      hold the default design's cycles against the simulator's.

The last two lines are a JSON ``kernels`` record and the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and float32 rate
# outside the tensor cores; used for each kernel's lower bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

CLASSIC = ["resnet50", "vgg16", "lstm", "dlrm", "bert_base", "bert_large",
           "gcn", "graphsage", "stencil2d", "merge_sort", "bfs_graph"]
LM = [("qwen2.5-32b", "prefill_32k"), ("granite-3-8b", "train_4k"),
      ("kimi-k2-1t-a32b", "decode_32k"), ("falcon-mamba-7b", "long_500k"),
      ("zamba2-1.2b", "train_4k")]

# The reference package's 20-step DOpt history for
#   repro.core.dopt.optimize(Graph.stack([lm_cell(a, s).pad_to(1024) for a, s in LM]),
#                            objective="edp", lr=0.05, steps=20)
# at the default design, run with JAX 0.9.0 on the CPU (float32, x64 off).
REF_HISTORY = {
    "objective": [14.148513793945312, 13.870190620422363, 13.592188835144043, 13.320175170898438,
                  13.032916069030762, 12.7896728515625, 12.550333976745605, 12.339588165283203,
                  12.082541465759277, 11.882933616638184, 11.66612434387207, 11.457076072692871,
                  11.2293062210083, 11.057284355163574, 10.8035306930542, 10.610099792480469,
                  10.411011695861816, 10.184656143188477, 9.982619285583496, 9.79565715789795],
    "runtime": [6981.8115234375, 6089.45849609375, 5285.28125, 4601.7822265625, 3993.958984375,
                3496.166748046875, 3041.1455078125, 2690.078857421875, 2393.89306640625,
                2136.758544921875, 1901.60546875, 1674.08935546875, 1474.2564697265625,
                1322.9212646484375, 1187.2471923828125, 1061.09423828125, 944.2295532226562,
                839.150146484375, 748.9849243164062, 673.27099609375],
    "energy": [651694.9375, 576358.75, 509851.53125, 451133.9375, 399273.0625, 353470.90625,
               312995.78125, 277238.125, 245629.5625, 217682.9375, 192955.796875, 171071.5625,
               151707.3125, 134579.109375, 119419.25, 105998.1953125, 94113.2890625, 83587.0234375,
               74263.5, 66003.75],
    "area": [598.8424072265625, 544.08984375, 496.70745849609375, 455.5601806640625, 419.69049072265625,
             389.3304138183594, 363.4437255859375, 340.99639892578125, 321.083251953125,
             303.258544921875, 287.1769104003906, 272.5820617675781, 259.2673645019531,
             247.0598602294922, 235.7674560546875, 225.29954528808594, 215.55613708496094,
             206.45245361328125, 197.9178009033203, 189.890625],
    "edp": [4550011392.0, 3509712640.0, 2694708736.0, 2076020096.0, 1594680192.0, 1235793280.0,
            951865728.0, 745792448.0, 588010880.0, 465135872.0, 366925792.0, 286389088.0,
            223655488.0, 178037568.0, 141780176.0, 112474072.0, 88864552.0, 70142064.0,
            55622240.0, 44438412.0],
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bucket(v: int) -> int:
    """The façade's vertex bucket: next power of two, at least 32."""
    return max(32, 1 << (max(v, 1) - 1).bit_length())


def median_ms(fn, device, n: int = 20) -> float:
    """Median time of ``n`` calls: CUDA events around each call on the card,
    the host clock on the CPU.  Two warm-up calls first."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, launches, name) of every kernel a torch.profiler run saw."""
    rows = []
    for avg in prof.key_averages():
        dt = getattr(avg, "self_device_time_total", 0.0) or 0.0
        if dt > 0 and getattr(avg, "device_type", None) is not None and "CUDA" in str(avg.device_type):
            rows.append((dt / 1e3, avg.count, avg.key))
    return rows


def device_ms(fn, n: int, kernel: str | None = None) -> tuple[float, str]:
    """Device time per call of ``fn`` from torch.profiler over ``n`` calls
    after one warm-up call: with ``kernel``, the mean time of the launches of
    kernels whose name holds it (the profiler may miss a launch at the edge
    of its window, so the mean is over the launches it saw); without, the
    summed time of every kernel the calls launch, over ``n``.  Should the
    profiler see no device time, CUDA events around the ``n`` calls run back
    to back, over ``n``.  Returns (ms, method)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in device_rows(prof) if kernel is None or kernel in r[2]]
    if rows:
        seen = sum(r[1] for r in rows)
        if kernel is not None:
            check(n // 2 <= seen <= n, f"profiler saw {seen} launches of {kernel} in {n} calls")
        return sum(r[0] for r in rows) / (seen if kernel is not None else n), f"profiler, {seen} launches"
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, "events over back-to-back calls"


def rel_close(got, ref, rtol: float) -> tuple[bool, float]:
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))
    return bool(np.all(np.isfinite(got))) and err <= rtol, err


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_env() -> str:
    import torch

    from repro_torch.kernels import runtime

    nvcc = subprocess.run([runtime.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    print("card:", smi)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    paths = runtime.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernels")
    for name, log in runtime.BUILD_LOG.items():
        for line in log.strip().splitlines():
            print(f"  {name}: {line}")
    cuobjdump = pathlib.Path(runtime.nvcc_path()).with_name("cuobjdump")
    for name, path in paths.items():
        elf = subprocess.run([str(cuobjdump), "--list-elf", str(path)], capture_output=True, text=True,
                             check=True).stdout
        print(f"  {name}: {' '.join(elf.split())}")
        check("sm_90a" in elf, f"{path.name} holds no sm_90a code")
    for name in paths:
        runtime.library(name)


def phase_kernels(device) -> dict:
    """Each kernel against its plain version; returns the kernel records."""
    import torch

    from repro_torch.core import ArchParams, TechParams, specialize
    from repro_torch.kernels import ops, ref, sscan
    from repro_torch.kernels import popsim_kernel as pk
    from repro_torch.workloads import lm_cell

    gen = torch.Generator(device.type).manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731

    # K1: forward and backward (the autograd path) at edge shapes and at every
    # shape the main path gives it: [1, bucket] for each simulate, [5, 1024]
    # for the LM-stack DOpt, [11, 256] for the classic DOpt
    k1_err = 0.0
    shapes = [(1, 1), (3, 33), (16, 707), (512, 4096), (len(LM), 1024), (len(CLASSIC), 256)]
    shapes += [(1, 1 << k) for k in range(5, 11)]
    for R, V in shapes:
        b = (0.4 * rand(R, V)).requires_grad_(True)
        cot = rand(R, V)
        s = sscan.affine_scan(0.8, b)
        (s * cot).sum().backward()
        s_ref = ref.affine_scan_reference(0.8, b.detach())
        g_ref = ref.affine_scan_reference(0.8, cot, reverse=True)
        for got, want, x in ((s.detach(), s_ref, b.detach()), (b.grad, g_ref, cot)):
            err = (got - want).abs()
            tol = 1e-6 * x.abs().max() + 1e-5 * want.abs()
            check(bool(torch.all(err <= tol)), f"affine_scan [{R},{V}] off its plain version by {float(err.max())}")
            k1_err = max(k1_err, float(err.max()))
        print(f"  affine_scan [{R},{V}] fwd+bwd within rtol 1e-5, atol 1e-6*max|x|")
    # timing at the main path's shape: the LM stack's [5, 1024] bw-EMA input.
    # ms / plain_ms: device time per call (kernel time, no host dispatch);
    # host_ms / plain_host_ms: CUDA events around each call, host path included
    b = 0.4 * rand(len(LM), 1024)
    kern = lambda: sscan.affine_scan_op(b, 0.8, False)  # noqa: E731
    plain = lambda: ref.affine_scan_reference(0.8, b)  # noqa: E731
    k1 = dict(bytes=2 * b.numel() * 4, ops=2 * b.numel(),
              host_ms=median_ms(kern, device), plain_host_ms=median_ms(plain, device))
    (k1["ms"], k1["ms_method"]), (k1["plain_ms"], _) = device_ms(kern, 100, "affine_scan_kernel"), device_ms(plain, 20)

    # K2: the qwen DFG against populations that scale cell_read_latency
    gp = ops.pack_graph(lm_cell("qwen2.5-32b", "prefill_32k", device=device))
    k2_err, k2 = 0.0, None
    for P in (512, 65536):
        scales = torch.linspace(0.5, 2.0, P, device=device)
        tech = TechParams.default(device)
        tech.cell_read_latency = tech.cell_read_latency * scales[:, None]
        cp = ops.pack_chw(specialize(tech, ArchParams.default(device)))
        got = ops.popsim(gp, cp)
        want = ref.popsim_reference(gp, cp)
        err = (got - want).abs()
        check(bool(torch.all(err <= 1e-3 + 1e-5 * want.abs())) and bool(torch.isfinite(got).all()),
              f"popsim P={P} off its plain version by {float(err.max())}")
        k2_err = max(k2_err, float(err.max()))
        print(f"  popsim P={P} V={gp.shape[0]} within rtol 1e-5, atol 1e-3 (max abs err {float(err.max()):.3g})")
        if P == 65536:
            kern = lambda: ops.popsim(gp, cp)  # noqa: E731
            plain = lambda: ref.popsim_reference(gp, cp)  # noqa: E731
            k2 = dict(bytes=(gp.numel() + cp.numel() + P * pk.OUT_COLS) * 4, ops=pk.operations(gp.shape[0], P),
                      host_ms=median_ms(kern, device), plain_host_ms=median_ms(plain, device, n=3))
            (k2["ms"], k2["ms_method"]), (k2["plain_ms"], _) = device_ms(kern, 20, "popsim_kernel"), device_ms(plain, 1)
    k1["max_abs_err"], k2["max_abs_err"] = k1_err, k2_err
    return {"affine_scan": k1, "popsim": k2}


def phase_simulate(device) -> None:
    from repro_torch.core import ArchParams, Graph, TechParams, simulate_stacked
    from repro_torch.workloads import get_workload, lm_cell

    rows = json.loads((ROOT / "results/bench/sim_speed.json").read_text())["rows"]
    expect = {r["workload"]: r["cycles_dsim"] for r in rows}
    tech, arch = TechParams.default(device), ArchParams.default(device)
    graphs = [(n, get_workload(n, device=device)) for n in CLASSIC]
    graphs += [(f"{a}:{s}", lm_cell(a, s, device=device)) for a, s in LM]
    check(sorted(expect) == sorted(n for n, _ in graphs), "sim_speed.json rows differ from the 16 workloads")
    for name, g in graphs:
        gs = Graph.stack([g.pad_to(bucket(g.n_vertices))])
        cyc = float(simulate_stacked(tech, arch, gs).cycles[0])
        ok, err = rel_close(cyc, expect[name], 1e-5)
        check(ok, f"{name}: cycles {cyc} vs cycles_dsim {expect[name]} (rel {err:.3g})")

        def run():
            simulate_stacked(tech, arch, gs).cycles.sum().item()

        t = median_ms(run, device, n=5)
        print(f"  simulate {name:28s} V={g.n_vertices:4d} bucket={gs.n_vertices:5d} cycles={cyc:.6e} "
              f"rel_err={err:.2e} steady={t:.3f} ms")


def phase_optimize(device) -> None:
    from repro_torch.core import Graph, MapperCfg, optimize
    from repro_torch.workloads import get_workload, lm_cell

    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    t0 = time.perf_counter()
    r = optimize(gs, objective="edp", lr=0.05, steps=20, device=device)
    dt = (time.perf_counter() - t0) / 20
    obj = r.history["objective"]
    check(all(map(lambda x: x == x and abs(x) != float("inf"), obj)), "non-finite DOpt history")
    check(obj[-1] < obj[0], f"DOpt objective did not decrease: {obj[0]} -> {obj[-1]}")
    for k, want in REF_HISTORY.items():
        ok, err = rel_close(r.history[k], want, 1e-3)
        check(ok, f"DOpt history '{k}' off the reference package's by rel {err:.3g}")
        print(f"  optimize LM stack [5,1024]: history '{k}' within rel {err:.2e} of the reference")
    print(f"  optimize LM stack: objective {obj[0]:.4f} -> {obj[-1]:.4f} in 20 steps, {dt * 1e3:.2f} ms/step "
          f"(first call included)")
    t0 = time.perf_counter()
    optimize(gs, objective="edp", lr=0.05, steps=20, device=device)
    print(f"  optimize LM stack: {(time.perf_counter() - t0) / 20 * 1e3:.2f} ms/step (warm)")

    cs = Graph.stack([get_workload(n, device=device).pad_to(256) for n in CLASSIC])
    hist = {}
    for impl in ("ref", "auto"):
        t0 = time.perf_counter()
        hist[impl] = optimize(cs, objective="edp", lr=0.05, steps=3, mcfg=MapperCfg(scan_impl=impl),
                              device=device).history
        print(f"  optimize classic [11,256] scan_impl={impl}: {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms/step")
    for k in REF_HISTORY:
        ok, err = rel_close(hist["auto"][k], hist["ref"][k], 1e-4)
        check(ok, f"classic stack: '{k}' of default vs scan_impl='ref' differs by rel {err:.3g}")
    print("  optimize classic: default and scan_impl='ref' histories agree within rtol 1e-4")


def phase_population(device) -> None:
    import torch

    from repro_torch.core import ArchParams, Graph, TechParams, simulate_stacked, specialize
    from repro_torch.kernels import ops
    from repro_torch.workloads import lm_cell

    g = lm_cell("qwen2.5-32b", "prefill_32k", device=device)
    gp = ops.pack_graph(g)
    P = 65536
    scales = torch.linspace(0.5, 2.0, P, device=device)
    tech, arch = TechParams.default(device), ArchParams.default(device)
    tech_p = TechParams.default(device)
    tech_p.cell_read_latency = tech_p.cell_read_latency * scales[:, None]
    out = ops.popsim(gp, ops.pack_chw(specialize(tech_p, arch)))
    check(tuple(out.shape) == (P, 8) and bool(torch.isfinite(out).all()), "population output malformed")
    one = ops.popsim(gp, ops.pack_chw(specialize(tech, arch)))
    cyc = float(simulate_stacked(tech, arch, Graph.stack([g])).cycles[0])
    ok, err = rel_close(float(one[0, 0]), cyc, 1e-5)
    check(ok, f"popsim cycles {float(one[0, 0])} vs simulate {cyc} at the default design (rel {err:.3g})")
    print(f"  population P={P} on qwen2.5-32b:prefill_32k: cycles {float(out[:, 0].min()):.4e}.."
          f"{float(out[:, 0].max()):.4e}; default design within rel {err:.2e} of simulate")


def phase_profile(device) -> None:
    """Where the time goes: one warm DOpt step on the LM stack and one
    simulate of qwen2.5-32b:prefill_32k under torch.profiler (each kernel
    alone is timed in phase kernels).  Prints wall time, summed device time,
    the device's idle share and the kernels with most device time.  Runs
    after the main path's launch counts are read, so its launches count
    nowhere."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ArchParams, Graph, TechParams, optimize, simulate_stacked
    from repro_torch.workloads import lm_cell

    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    q = Graph.stack([lm_cell("qwen2.5-32b", "prefill_32k", device=device).pad_to(1024)])
    tech, arch = TechParams.default(device), ArchParams.default(device)
    work = {
        "dopt_step_lm_stack": lambda: optimize(gs, objective="edp", lr=0.05, steps=1, device=device),
        "simulate_qwen": lambda: simulate_stacked(tech, arch, q).cycles.sum().item(),
    }
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        n_kern = sum(r[1] for r in rows)
        if busy == 0.0:
            print(f"  profile {name}: wall {wall:.3f} ms; device time not measured (profiler saw none)")
            continue
        top = sorted(rows, reverse=True)[:4]
        print(f"  profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms over {n_kern} kernels, "
              f"idle share {max(0.0, 1 - busy / wall):.3f}; top: "
              + "; ".join(f"{k[:48]} {t:.4f} ms x{c}" for t, c, k in top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    device = runtime.resolve_device(None)
    smi = phase_env()
    phase_build()
    print("kernels against their plain versions:")
    rec = phase_kernels(device)

    print("main path:")
    runtime.reset_launches()
    phase_simulate(device)
    phase_optimize(device)
    phase_population(device)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"main-path launches: {launches}")
    print("where the time goes:")
    phase_profile(device)

    meta = {
        "affine_scan": ("src/repro_torch/kernels/csrc/affine_scan.cu", "src/repro/kernels/sscan.py:134"),
        "popsim": ("src/repro_torch/kernels/csrc/popsim.cu", "src/repro/kernels/popsim_kernel.py:152"),
    }
    kernels = []
    for name, r in rec.items():
        t_bytes, t_ops = r["bytes"] / HBM_BYTES_PER_S * 1e3, r["ops"] / FP32_OPS_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
        ))
        print(f"  {name}: device {r['ms']:.6f} ms ({r['ms_method']}), host path {r['host_ms']:.6f} ms per call; "
              f"plain device {r['plain_ms']:.6f} ms, host path {r['plain_host_ms']:.6f} ms per call")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
