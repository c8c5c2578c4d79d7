"""What every driver shares, and how a mix's driver is found.

A mix (``chipbench/traffic/<mix>.json``) names its ``entry``, the program's
entry point it drives; the driver of that entry is the file
``chipbench/drivers/<entry>.py``, whose class ``Driver`` (a subclass of
:class:`BaseDriver`) the harness loads by path.  A driver gives:

  * ``setup()``: the inputs from the seed, and every shape the window uses
    warmed up;
  * ``window(seconds)``: the measured window, returning its record: at least
    ``seconds`` (its whole length) and ``calls`` (calls made into the
    program), and the counts or times that the cell's end-to-end readers
    (``chipbench/metrics/<metric>.py``) read;
  * ``calls(n)``: ``n`` calls, for the traced window, returning the work done
    (which the per-layer readers read);
  * ``release()``, then ``check()``: the numbers that decide ``correct``;
  * ``readings(requests)``: what ``calibrate.py`` prints, the control's and
    the faults' readings beside the sound ones.

A new mix that names an existing entry needs no code; a new entry is a new
driver file.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import torch

from chipbench.harness.trace import Trace, profiled
from chipbench.inputs import draws


def program():
    """The program under test: the modules the drivers call, looked up at
    call time (so that a test can put a broken path in their place)."""
    from repro_torch.core import popsim
    from repro_torch.core.graph import Graph
    from repro_torch.core.params import ArchParams, ArchSpec, TechParams

    return popsim, Graph, TechParams, ArchParams, ArchSpec


def load(root: pathlib.Path, entry: str) -> type:
    """The ``Driver`` class of ``chipbench/drivers/<entry>.py`` in the
    checkout at ``root``."""
    path = root / "chipbench" / "drivers" / f"{entry}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_driver_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def leaves(tree) -> dict:
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(f"chipbench::{name}")


class BaseDriver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, log=lambda what: None):
        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        self.P = mix["population"]

    def _inputs(self):
        popsim, Graph, TechParams, ArchParams, ArchSpec = program()
        self.g = draws.graph_stack(self.cfg)
        self.spec, self.seeds = draws.seed_designs(self.cfg["seeds"])
        self.gs = Graph.from_numpy(self.g, tuple(self.cfg["workloads"]), self.device)
        self.pspec = ArchSpec(**{k: tuple(v) for k, v in self.spec.items()})
        self.k1 = (self.P * len(self.cfg["workloads"]), self.cfg["bucket"])
        self.log("graphs and seed designs made")

    def traced(self) -> Trace:
        """``trace_calls`` calls under the profiler."""
        out = {}
        with profiled(out, cuda=self.device.type == "cuda"):
            work = self.calls(self.mix["trace_calls"])
        return Trace(kernels=out["kernels"], window_s=out["window_s"], busy_s=out["busy_s"], work=work,
                     shapes={"k1": self.k1}, breakdown=out["breakdown"])
