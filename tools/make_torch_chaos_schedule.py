"""Make ``tests/data/torch_chaos_schedule.json``: the reference package's
seeded chaos schedules for the design service, so that the port's can be
held against them where the reference cannot run (the card has no JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_chaos_schedule.py [--check-port]

The schedules: ``ChaosInjector(config).schedule(range(200))`` of the
reference (``repro.serving.chaos``), each plan as ``FaultPlan.to_json()``,
for the three configurations of ``benchmarks/bench_serving.py`` at its seed
20260808: ``transient_only`` (the chaos probe's availability-1.0 gate),
``full`` (transients, NaN poisoning and latency spikes) and ``worker_kill``
(the pool's process-kill fault).  ``chip_smoke.py``'s design path requires
the port's schedule of its first 96 queries to equal the file's.

``--check-port`` then draws the port's schedules (``repro_torch.serving.chaos``)
and exits non-zero unless they equal the file's.  Seconds on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "tests" / "data" / "torch_chaos_schedule.json"

SEED = 20260808  # benchmarks/bench_serving.py's _SEED
QUERIES = 200
CONFIGS = {
    "transient_only": dict(seed=SEED, p_transient=0.35, p_compile_fail=0.2, p_cache_corrupt=0.2),
    "full": dict(seed=SEED, p_transient=0.3, p_compile_fail=0.1, p_nan=0.25, p_latency=0.2, latency_s=0.02),
    "worker_kill": dict(seed=SEED, p_worker_kill=0.1),
}


def schedules(chaos) -> dict:
    """name -> [plan.to_json() for qid in range(QUERIES)] under ``chaos``,
    the reference's or the port's chaos module."""
    return {name: [p.to_json() for p in chaos.ChaosInjector(chaos.ChaosConfig(**kw)).schedule(range(QUERIES))]
            for name, kw in CONFIGS.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-port", action="store_true", help="hold the port's schedules against the file")
    args = ap.parse_args()
    from repro.serving import chaos as ref_chaos

    doc = dict(seed=SEED, queries=QUERIES, configs=CONFIGS, schedules=schedules(ref_chaos),
               fields=[f.name for f in dataclasses.fields(ref_chaos.FaultPlan)])
    OUT.write_text(json.dumps(doc, indent=None, separators=(",", ":")) + "\n")
    faulty = {name: sum(not ref_chaos.FaultPlan(**p).clean or p["worker_kill"] for p in plans)
              for name, plans in doc["schedules"].items()}
    print(f"wrote {OUT.relative_to(ROOT)}: {QUERIES} plans a configuration, faulted {faulty}")
    if args.check_port:
        from repro_torch.serving import chaos as port_chaos

        got = schedules(port_chaos)
        bad = [name for name in CONFIGS if got[name] != doc["schedules"][name]]
        print("port schedules " + ("differ: " + ", ".join(bad) if bad else "equal the reference's"))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
