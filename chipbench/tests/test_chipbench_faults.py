"""The comparison that decides ``correct`` fails its control and every fault
a cell can have, at the tiny cells' sizes on the CPU.

The faults are planted in the program, underneath a whole run: a descent
step that returns its state unchanged; half of the workloads left out of the
objective, the mean taken over the rest; an answer altered where it is
produced.  The control is the reference computed in bfloat16 in the program's
place.  (One chip, so no exchange between chips to leave out.)"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from chipbench.harness import checks, drive
from chipbench.tests.conftest import TINY, run_cell

DESCENT, SWEEP = "tiny_lm.tiny_descent", "tiny_classic.tiny_sweep"


def _half(gs):
    from repro_torch.core.graph import DATA_FIELDS, Graph

    w = (gs.n_comp.shape[0] + 1) // 2
    return Graph(**{f: getattr(gs, f)[:w] for f in DATA_FIELDS}, names=gs.names[:w])


def unchanged(real):
    def chunk(state, *a, **k):
        return state, real(state, *a, **k)[1]
    return chunk


def half_chunk(real):
    def chunk(state, mixes, gs, *a, **k):
        return real(state, mixes, _half(gs), *a, **k)
    return chunk


def altered_chunk(real):
    def chunk(*a, **k):
        state, rows = real(*a, **k)
        rows = rows.copy()
        rows[:, 0, 0] = rows[:, 1, 0]
        return state, rows
    return chunk


def half_metrics(real):
    def metrics(tech, arch, gs, *a, **k):
        return real(tech, arch, _half(gs), *a, **k)
    return metrics


def altered_metrics(real):
    def metrics(*a, **k):
        out = [x.clone() for x in real(*a, **k)]
        for x in out:
            x[0] = x[1]
        return tuple(out)
    return metrics


@pytest.mark.parametrize("cell,entry,fault", [
    (DESCENT, "population_chunk", unchanged),
    (DESCENT, "population_chunk", half_chunk),
    (DESCENT, "population_chunk", altered_chunk),
    (SWEEP, "population_log_metrics", half_metrics),
    (SWEEP, "population_log_metrics", altered_metrics),
], ids=["descent-unchanged", "descent-half", "descent-altered", "sweep-half", "sweep-altered"])
def test_a_broken_path_is_not_correct(checkout, monkeypatch, capsys, cell, entry, fault):
    from repro_torch.core import popsim

    rc, res = run_cell(checkout, cell, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    monkeypatch.setattr(popsim, entry, fault(getattr(popsim, entry)))
    rc, res = run_cell(checkout, cell, capsys=capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]


def _driver(checkout, cell, seed):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = json.loads((checkout / "chipbench" / "configs" / f"{c['config']}.json").read_text())
    mix = json.loads((checkout / "chipbench" / "traffic" / f"{c['traffic']}.json").read_text())
    run = drive.load(checkout, mix["entry"])(cfg, mix, seed, torch.device("cpu"))
    run.setup()
    return run


def _fails(numbers: dict, cell: str, checkout) -> bool:
    limits = json.loads((checkout / "chipbench" / "cells" / f"{TINY[cell]['limits']}.json").read_text())["checks"]
    return any(not np.isfinite(numbers[k]) or numbers[k] > v["limit"] for k, v in limits.items())


@pytest.mark.parametrize("seed", [5, 2**31 + 11, 77])
def test_the_bfloat16_control_is_not_correct(checkout, seed):
    run = _driver(checkout, DESCENT, seed)
    ref = run.reference()
    assert _fails(checks.descent_numbers(run.reference(torch.bfloat16), ref), DESCENT, checkout)
    run = _driver(checkout, SWEEP, seed)
    run.calls(3)
    gaps = [checks.sweep_gaps(run.reference_answer(i, torch.bfloat16), run.reference_answer(i))
            for i in run.sample()]
    assert _fails(checks.sweep_numbers(np.concatenate(gaps)), SWEEP, checkout)
