"""One run of one cell: load, warm up, measure or trace, check, print.

``python chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

The cell is found by name in ``BENCHMARK.json``; its configuration, traffic
mix, driver, correctness limits and metric readers are files under
``chipbench/`` found by their names (``configs/<config>.json``,
``traffic/<mix>.json``, ``drivers/<the mix's entry>.py``,
``cells/<cell>.json``, ``metrics/<metric>.py``; every metric but ``setup_s``
has a reader, which reads the window's record or the traced window).  The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
then ``checks``, each number compared beside its limit, which the last lines
of standard error repeat.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

from chipbench.harness import guard


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="chipbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only the first run of a cell there builds."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(root: pathlib.Path, name: str):
    """The metric reader ``chipbench/metrics/<name>.py``'s ``read``."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def main(argv, root: pathlib.Path, t0: float, device=None) -> int:
    """Run one cell; return the exit code.  ``device`` None takes the card
    (and fails without one); a test passes the CPU to drive the rest."""
    args = parse(argv)
    found = guard.forbidden_loaded()
    if found:
        print(f"chipbench: loaded before the run: {found}", file=sys.stderr)
        return 3
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"chipbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    set_cache_dirs(root)

    def log(what: str) -> None:
        print(f"{what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    import torch

    log("torch imported")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"chipbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        log("CUDA context made")
    from chipbench.harness import drive
    from chipbench.reference import sim

    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[cell["config"]]["file"])
    mix = load_json(root / "chipbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "chipbench" / "cells" / f"{cell['name']}.json")["checks"]
    run = drive.load(root, mix["entry"])(cfg, mix, args.seed, device, log)
    run.setup()
    setup_s = time.perf_counter() - t0
    if args.trace:
        trace = run.traced()
        work = trace.work
    else:
        work = run.window(args.seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.release()
    if cuda:
        torch.cuda.empty_cache()
    sim.float32_numerics()
    numbers = run.check()

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                value = reader(root, m["name"])(trace)
                if value is None:
                    print(f"chipbench: {m['name']} found nothing to read", file=sys.stderr)
                else:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]):
                value = setup_s if m["name"] == "setup_s" else reader(root, m["name"])(work)
                if value is None:
                    print(f"chipbench: {m['name']} found nothing to read in the window", file=sys.stderr)
                    return 3
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    compared = {name: {"value": numbers[name], "limit": lim["limit"]} for name, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak,
           "power_limit": power_limit() if cuda else "not read"}
    result = {"correct": correct, "attempted": work["calls"], "failed": 0, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = trace.breakdown
    result["checks"] = compared
    found = guard.forbidden_loaded()  # after the window, the check and the readers
    if found:
        print(f"chipbench: loaded by the run: {found}", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in numbers.items() if k not in compared}), file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
