"""The driver of ``population_chunk``: DOpt over a population, one
closed-loop client.

Set-up makes ``population`` members from the configuration's seed designs
with log-space jitter, their objective mixes and budgets, builds the
program's population state, drives it through ``first_steps`` (epochs a
call, the window's own call) and one warm call of ``epochs_per_call`` epochs,
and hands that state to the window, which calls ``population_chunk`` back to
back, carrying the state, each call ending in its one host copy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from chipbench.harness import checks
from chipbench.harness.drive import BaseDriver, leaves, program, span, sync
from chipbench.inputs import draws
from chipbench.reference import sim


class Driver(BaseDriver):
    entry = "population_chunk"

    def setup(self) -> None:
        popsim, Graph, TechParams, ArchParams, ArchSpec = program()
        self._inputs()
        mix, dev, P = self.mix, self.device, self.P
        self.tech, self.arch = draws.population(self.seeds, P, mix["jitter_sigma"], self.seed, 0, dev)
        w = draws.mixes(P, mix["mix_concentration"], self.seed, 1)
        area_b, power_b = draws.seed_budgets(self.seeds, self.spec, self.g, dev)
        self.mixes = (torch.as_tensor(w, device=dev), torch.full((P,), area_b, device=dev),
                      torch.full((P,), power_b, device=dev))
        self.lr = torch.tensor(mix["lr"], device=dev)
        self.sched = torch.full((mix["epochs_per_call"],), mix["penalty_weight"], device=dev)
        state = popsim.init_population_state(TechParams(**self.tech), ArchParams(**self.arch))
        sync(dev)
        self.log("population, mixes and budgets made")
        z0 = {**leaves(state[0]), **leaves(state[1])}
        rows, grad = [], None
        for n in mix["first_steps"]:
            state, r = self._call(state, n)
            rows.append(r)
            if grad is None:  # the first gradient, from Adam's first moment after one epoch
                grad = {k: (x / (1 - checks.B1)).cpu() for t in state[2:] for k, x in leaves(t.m).items()}
        z = {**leaves(state[0]), **leaves(state[1])}
        self.first = dict(rows=np.concatenate(rows)[:3], grad=grad, change={k: (z[k] - z0[k]).cpu() for k in z})
        self.log("first steps done")
        self.state, _ = self._call(state, mix["epochs_per_call"])  # warm: the window's call at its size
        sync(dev)
        self.log("warm call done")

    def _call(self, state, n: int):
        popsim = program()[0]
        with span(self.entry):
            return popsim.population_chunk(state, self.mixes, self.gs, self.lr, self.sched[:n], spec=self.pspec)

    def calls(self, n_calls: int) -> dict:
        n = self.mix["epochs_per_call"]
        for _ in range(n_calls):
            self.state, _ = self._call(self.state, n)
        return {"epochs": n_calls * n, "calls": n_calls}

    def window(self, seconds: float) -> dict:
        n, calls = self.mix["epochs_per_call"], 0
        t0 = time.perf_counter()
        while True:
            self.state, _ = self._call(self.state, n)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        self.log(f"window: {calls} calls of {n} epochs in {dt:.3f} s")
        return {"seconds": dt, "calls": calls, "member_epochs": self.P * n * calls}

    def release(self) -> None:
        self.state = None

    def check(self) -> dict:
        """The reference's first three epochs from the same inputs, against
        the program's."""
        return checks.descent_numbers(self.first, self.reference())

    def reference(self, dtype=torch.float32, graph_slice=slice(None)) -> dict:
        """The reference's rows, first gradient and change over three epochs;
        ``dtype`` and ``graph_slice`` run it in a lower precision or over part
        of the workloads (the control and a planted fault)."""
        dev = self.device
        cast = lambda t: {k: x.to(dtype) for k, x in t.items()}  # noqa: E731
        g = {k: x[graph_slice] for k, x in draws.to_device(self.g, dev, dtype).items()}
        mixes = tuple(x.to(dtype) for x in self.mixes)
        state = sim.init_state(cast(self.tech), cast(self.arch))
        z0 = {**state["z"][0], **state["z"][1]}
        bounds = sim.log_bounds(dev, dtype)
        rows, grad = [], None
        for e in range(3):
            state, row, _ = sim.population_step(state, mixes, g, self.spec, self.lr.to(dtype),
                                                self.sched[e % self.sched.shape[0]].to(dtype), bounds)
            rows.append(row.float().cpu().numpy())
            if grad is None:
                grad = {k: (x / (1 - checks.B1)).float().cpu() for m in state["m"] for k, x in m.items()}
        z = {**state["z"][0], **state["z"][1]}
        return dict(rows=np.stack(rows), grad=grad, change={k: (z[k] - z0[k]).float().cpu() for k in z})

    def readings(self, requests: int) -> dict:
        """The sound readings; the reference in bfloat16 (the control); and
        each fault planted: half of the workloads left out of the mean, the
        state left unchanged, one member's answer replaced by its
        neighbour's."""
        self.release()
        sim.float32_numerics()
        ref = self.reference()
        out = {"sound": checks.descent_numbers(self.first, ref),
               "bf16": checks.descent_numbers(self.reference(torch.bfloat16), ref)}
        w = len(self.cfg["workloads"])
        out["half_batch"] = checks.descent_numbers(self.reference(graph_slice=slice(0, (w + 1) // 2)), ref)
        still = dict(self.first, change={k: torch.zeros_like(x) for k, x in self.first["change"].items()})
        out["unchanged"] = checks.descent_numbers(still, ref)
        rows = self.first["rows"].copy()
        rows[:, 0] = rows[:, 1]
        out["altered"] = checks.descent_numbers(dict(self.first, rows=rows), ref)
        return out
