"""Fixtures of the benchmark's CPU tests: a temporary checkout of the
benchmark, with tiny cells added beside the real ones as new files."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny stand-ins of the real cells: the same entries, traffic and limits at a
# size a CPU test holds
TINY = {
    "tiny_lm.tiny_descent": dict(
        config={"name": "tiny_lm", "workloads": ["lstm", "bert_base"], "bucket": 128},
        traffic={"name": "tiny_descent", "from": "descent", "population": 12, "epochs_per_call": 2, "trace_calls": 1},
        limits="lm_stack.descent"),
    "tiny_classic.tiny_sweep": dict(
        config={"name": "tiny_classic", "workloads": ["lstm", "gcn", "bfs_graph"], "bucket": 32},
        traffic={"name": "tiny_sweep", "from": "sweep", "population": 20, "reference_block": 8, "trace_calls": 2,
                 "check_requests": 3},
        limits="classic.sweep"),
}


def add_tiny_cells(root: pathlib.Path) -> None:
    """Register TINY's configurations, mixes and cells in the checkout at
    ``root`` as new files and new BENCHMARK.json entries."""
    cb = root / "chipbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, t in TINY.items():
        cfg = dict(json.loads((cb / "configs" / "lm_stack.json").read_text()), **t["config"])
        (cb / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        mix = json.loads((cb / "traffic" / f"{t['traffic']['from']}.json").read_text())
        mix.update({k: v for k, v in t["traffic"].items() if k not in ("name", "from")})
        (cb / "traffic" / f"{t['traffic']['name']}.json").write_text(json.dumps(mix))
        shutil.copy(cb / "cells" / f"{t['limits']}.json", cb / "cells" / f"{cell}.json")
        bench["configs"].append({"name": cfg["name"], "source": "test", "file": f"chipbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": t["traffic"]["name"], "chips": 1,
                                   "why": "test"})
        real = {w["name"]: w for w in bench["workloads"]}[t["limits"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real["name"] in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> pathlib.Path:
    """A copy of BENCHMARK.json and chipbench/ with the tiny cells added."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", root / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(root)
    return root


def run_cell(root: pathlib.Path, cell: str, trace: int = 0, seed: int = 3_000_000_019, capsys=None) -> tuple:
    """Drive one run of ``cell`` on the CPU (the harness's look for a card
    skipped); returns (exit code, the result line as a dict or None)."""
    import torch

    from chipbench.harness import bench

    rc = bench.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)],
                    root=root, t0=time.perf_counter(), device=torch.device("cpu"))
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)
