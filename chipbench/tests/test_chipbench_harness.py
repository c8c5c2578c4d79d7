"""The harness end to end on the CPU (its look for a card skipped), at the
tiny cells' sizes: what a run prints, what it refuses, and that a new
configuration, mix, cell and per-layer metric need only new files."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import pytest

from chipbench.harness import guard
from chipbench.tests.conftest import ROOT, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny_lm.tiny_descent", "tiny_classic.tiny_sweep"])
def test_a_run_prints_its_result_last(checkout, cell, capsys):
    rc, res = run_cell(checkout, cell, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want and "setup_s" in want
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny_lm.tiny_descent", "tiny_classic.tiny_sweep"])
def test_a_traced_run_gives_the_window_and_breakdown(checkout, cell, capsys):
    rc, res = run_cell(checkout, cell, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, str(ROOT / "chipbench" / "run.py"), "--workload", "lm_stack.descent",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert guard.top_levels(["repro_torch.core.popsim", "reprox"]) == {"repro_torch", "reprox"}
    assert guard.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert guard.forbidden_loaded() == ["repro"]


def test_a_run_that_loaded_jax_gives_no_result(checkout, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, res = run_cell(checkout, "tiny_classic.tiny_sweep", capsys=capsys)
    assert rc != 0 and res is None


@pytest.mark.parametrize("trace", [0, 1])
def test_a_reader_that_loads_jax_gives_no_result(tmp_path, trace, capsys):
    """A forbidden module loaded after the window, here by a metric's reader,
    refuses the run as well."""
    root = _copy(tmp_path)
    (root / "chipbench" / "metrics" / "planted.py").write_text(
        "import sys\nimport types\n\n\ndef read(record):\n"
        "    sys.modules['flax'] = types.ModuleType('flax')\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    metric = {"name": "planted", "unit": "ms", "better": "lower", "source": "host_clock",
              "workloads": ["classic.sweep"]}
    if trace:
        metric.update(source="program_counter", layer="simulator", moves="designs_per_s")
    bench["per_layer" if trace else "end_to_end"].append(metric)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny = {"population": 10, "reference_block": 5, "trace_calls": 1, "check_requests": 1}
    _throwaway_cell(root, "classic.json", "sweep.json", "classic.sweep.json", tiny, ["classic.sweep"])
    try:
        rc, res = run_cell(root, "throwaway.throwaway_mix", trace=trace, capsys=capsys)
    finally:
        sys.modules.pop("flax", None)
    assert rc != 0 and res is None


def _copy(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _throwaway_cell(root, config, traffic, limits, mix_update, like) -> None:
    """A configuration ``throwaway`` (two small workloads of ``config``), a mix
    ``throwaway_mix`` (``traffic`` updated) and their cell, with the limits of
    ``limits`` and the end-to-end metrics of the cells in ``like``."""
    cb = root / "chipbench"
    (cb / "configs" / "throwaway.json").write_text(json.dumps(
        dict(json.loads((cb / "configs" / config).read_text()), name="throwaway",
             workloads=["merge_sort", "stencil2d"], bucket=32)))
    (cb / "traffic" / "throwaway_mix.json").write_text(json.dumps(
        dict(json.loads((cb / "traffic" / traffic).read_text()), **mix_update)))
    (cb / "cells" / "throwaway.throwaway_mix.json").write_text((cb / "cells" / limits).read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "test", "file": "chipbench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.throwaway_mix", "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if set(like) & set(m.get("workloads", [])):
            m["workloads"].append("throwaway.throwaway_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "chipbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


THROWAWAY_DRIVER = """from pathlib import Path

from chipbench.harness import drive

Sweep = drive.load(Path(__file__).resolve().parents[2], "population_log_metrics")


class Driver(Sweep):
    entry = "throwaway_entry"

    def window(self, seconds):
        record = super().window(seconds)
        return dict(record, worst_s=max(record["latency_s"]))
"""


def test_new_files_alone_register_a_cell(tmp_path, capsys):
    """A throwaway configuration, mix, driver, cell, end-to-end metric and
    per-layer metric, added as new files and BENCHMARK.json entries, are
    found by name; no file edited."""
    root = _copy(tmp_path)
    before = _digests(root)
    cb = root / "chipbench"
    (cb / "drivers" / "throwaway_entry.py").write_text(THROWAWAY_DRIVER)
    (cb / "metrics" / "sweep_max_ms.py").write_text("def read(window):\n    return window['worst_s'] * 1e3\n")
    (cb / "metrics" / "requests_traced.throwaway.py").write_text(
        "def read(trace):\n    return float(trace.work['requests'])\n")
    tiny = {"entry": "throwaway_entry", "population": 10, "reference_block": 5, "trace_calls": 2,
            "check_requests": 2}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "sweep_max_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": []})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _throwaway_cell(root, "classic.json", "sweep.json", "classic.sweep.json", tiny, ["classic.sweep"])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"][-1]["workloads"].append("throwaway.throwaway_mix")
    bench["per_layer"].append({"name": "requests_traced.throwaway", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "simulator", "moves": "designs_per_s",
                               "workloads": ["throwaway.throwaway_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    added = set(_digests(root)) - set(before)
    assert all(_digests(root)[k] == v for k, v in before.items())
    assert len(added) == 6
    rc, res = run_cell(root, "throwaway.throwaway_mix", capsys=capsys)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"designs_per_s", "sweep_p95_ms", "sweep_max_ms", "setup_s"}
    assert res["metrics"]["sweep_max_ms"]["value"] >= res["metrics"]["sweep_p95_ms"]["value"]
    rc, res = run_cell(root, "throwaway.throwaway_mix", trace=1, capsys=capsys)
    assert rc == 0 and res["metrics"] == {"requests_traced.throwaway": {"value": 2.0, "unit": "requests"}}
