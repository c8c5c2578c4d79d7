"""The driver of ``population_log_metrics``: DSim over a design sweep, one
closed-loop client.

Each request is ``population`` fresh designs drawn from the run's seed,
answered with their log metrics and worst-case area and power, and timed
from its call to the host copy of its answers.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from chipbench.harness import checks
from chipbench.harness.drive import BaseDriver, program, span, sync
from chipbench.inputs import draws
from chipbench.reference import sim


class Driver(BaseDriver):
    entry = "population_log_metrics"

    def setup(self) -> None:
        self._inputs()
        self.next, self.answers, self.latency = 0, {}, []
        for _ in range(self.mix["warm_calls"]):
            self._request(keep=False)
            self.log("warm request done")
        sync(self.device)

    def designs(self, i: int) -> tuple[dict, dict]:
        return draws.population(self.seeds, self.P, self.mix["jitter_sigma"], self.seed, draws.SWEEP_STREAM + i,
                                self.device)

    def _request(self, keep: bool = True) -> None:
        popsim, Graph, TechParams, ArchParams, ArchSpec = program()
        i = self.next
        self.next += 1
        tech, arch = self.designs(i)
        t0 = time.perf_counter()
        with span(self.entry):
            out = popsim.population_log_metrics(TechParams(**tech), ArchParams(**arch), self.gs, self.pspec)
            answer = tuple(x.cpu().numpy() for x in out)
        if keep:
            self.latency.append(time.perf_counter() - t0)
            self.answers[i] = answer

    def calls(self, n_calls: int) -> dict:
        for _ in range(n_calls):
            self._request()
        return {"requests": n_calls, "calls": n_calls}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self._request()
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        n = len(self.latency)
        q = statistics.quantiles(np.asarray(self.latency) * 1e3, n=4)
        self.log(f"window: {n} requests in {dt:.3f} s; latency ms quartiles {q[0]:.3f} {q[1]:.3f} {q[2]:.3f}, "
                 f"max {max(self.latency) * 1e3:.3f}")
        return {"seconds": dt, "calls": n, "designs": self.P * n, "latency_s": list(self.latency)}

    def release(self) -> None:
        pass

    def sample(self) -> list:
        """The requests the check compares, drawn from the run's seed."""
        done = sorted(self.answers)
        rng = np.random.default_rng(draws.stream_seed(self.seed, 99))
        k = min(self.mix["check_requests"], len(done))
        return sorted(int(i) for i in rng.choice(done, size=k, replace=False))

    def reference_answer(self, i: int, dtype=torch.float32) -> tuple:
        """The reference's answer to request ``i``, in blocks of designs."""
        tech, arch = self.designs(i)
        g = draws.to_device(self.g, self.device, dtype)
        block = self.mix["reference_block"]
        parts = [sim.evaluate({k: x[s:s + block].to(dtype) for k, x in tech.items()},
                              {k: x[s:s + block].to(dtype) for k, x in arch.items()}, g, self.spec)
                 for s in range(0, self.P, block)]
        return tuple(torch.cat([p[j] for p in parts]).float().cpu().numpy() for j in range(3))

    def check(self) -> dict:
        """Every design of the sampled requests against the reference."""
        gaps = [checks.sweep_gaps(self.answers[i], self.reference_answer(i)) for i in self.sample()]
        return checks.sweep_numbers(np.concatenate(gaps))

    def readings(self, requests: int) -> dict:
        """After ``requests`` requests: the sound readings; the reference in
        bfloat16 (the control); and an answer altered where it is produced
        (each sampled request's first design given its neighbour's)."""
        self.calls(requests)
        sim.float32_numerics()
        sample = self.sample()
        ref = {i: self.reference_answer(i) for i in sample}

        def numbers(answer):
            return checks.sweep_numbers(np.concatenate([checks.sweep_gaps(answer(i), ref[i]) for i in sample]))

        def altered(i):
            a = tuple(x.copy() for x in self.answers[i])
            for x in a:
                x[0] = x[1]
            return a

        return {"sound": numbers(lambda i: self.answers[i]),
                "bf16": numbers(lambda i: self.reference_answer(i, torch.bfloat16)),
                "altered": numbers(altered)}
