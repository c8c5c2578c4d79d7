"""Readings from which the correctness limits of a cell are set.

    python chipbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process on the card, the cell's driver
(``drivers/<entry>.py``) sets up as a run does and gives its ``readings``:
the program against the plain reference (the sound readings), and in the
program's place the reference computed in bfloat16 (the control) and with
each fault the cell can have planted.  One JSON line a seed.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=8, help="sweep requests answered before the check")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from chipbench.harness import bench, drive

    bench.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    cfg = bench.load_json(ROOT / {c["name"]: c for c in spec["configs"]}[cell["config"]]["file"])
    mix = bench.load_json(ROOT / "chipbench" / "traffic" / f"{cell['traffic']}.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = drive.load(ROOT, mix["entry"])(cfg, mix, seed, device)
        run.setup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = run.readings(args.requests)
        print(json.dumps({"seed": seed, "setup_s": t1 - t0, "readings_s": time.perf_counter() - t1,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **out}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
