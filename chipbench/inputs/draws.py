"""The benchmark's inputs, made from ``--seed``: graphs, seed designs, jitter,
objective mixes and budgets.

Everything the program and the reference are given comes from here, and both
are given the same arrays.  Random draws are made on the device by a
``torch.Generator`` seeded from ``(seed, stream)``, in one call for a whole
population; the Dirichlet objective mixes are drawn on the host by numpy (a
[P, 3] draw).  Stream numbers keep the draws of one run apart: the descent's
population is stream 0, its mixes stream 1, and sweep request ``i`` is stream
``100 + i``, so any request's designs can be made again after the window.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from chipbench.inputs import graphs
from chipbench.reference import sim

DESIGNS = pathlib.Path(__file__).resolve().parent / "designs.json"
SWEEP_STREAM = 100


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of one run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def graph_stack(cfg: dict) -> dict:
    """The configuration's workloads, padded to its bucket and stacked."""
    return graphs.stack([graphs.workload_graph(n) for n in cfg["workloads"]], cfg["bucket"])


def seed_designs(names) -> tuple[dict, list[tuple[dict, dict]]]:
    """(spec, [(tech, arch)] as numpy float32 trees) of the named library designs."""
    lib = json.loads(DESIGNS.read_text())
    trees = []
    for n in names:
        d = lib["designs"][n]
        trees.append(tuple({f: np.asarray(d[k][f], np.float32) for f in fields}
                           for k, fields in (("tech", sim.TECH_FIELDS), ("arch", sim.ARCH_FIELDS))))
    return lib["spec"], trees


def n_params() -> int:
    return sum(int(np.prod(s)) for fields in sim.FIELDS for s in fields.values())


def population(seeds: list, n: int, sigma: float, seed: int, stream: int, device) -> tuple[dict, dict]:
    """``n`` members round-robin over the seed designs, each parameter moved
    by ``sigma`` times a standard normal draw in log space and clamped into
    the bounds; the first ``len(seeds)`` members are the seed designs as
    written.  All fields are drawn and moved as one [n, 59] block (a few
    launches a population), then split into contiguous leaves."""
    k = n_params()
    noise = torch.randn((n, k), generator=generator(seed, stream, device), device=device)
    packed = torch.as_tensor(np.stack([_pack(s) for s in seeds]), device=device)
    lo, hi = (torch.as_tensor(np.log(np.maximum(_pack(b), 1e-30)).astype(np.float32), device=device)
              for b in zip(*sim.BOUNDS))
    leaf = packed[torch.arange(n, device=device) % len(seeds)]
    moved = torch.exp(torch.minimum(torch.maximum(torch.log(leaf) + sigma * noise, lo), hi))
    flat = torch.where((torch.arange(n, device=device) >= len(seeds))[:, None], moved, leaf)
    out, col = [], 0
    for fields in sim.FIELDS:
        tree = {}
        for f, shape in fields.items():
            w = int(np.prod(shape))
            tree[f] = flat[:, col:col + w].reshape((n,) + shape).contiguous()
            col += w
        out.append(tree)
    return tuple(out)


def _pack(trees) -> np.ndarray:
    """A (tech, arch) pair of numpy trees as one float32 row in field order."""
    return np.concatenate([np.asarray(t[f], np.float32).reshape(-1) for t, fields in zip(trees, sim.FIELDS)
                           for f in fields])


def mixes(n: int, concentration: float, seed: int, stream: int) -> np.ndarray:
    """[n, 4] weights over (time, energy, area, edp): one-hot corners on time,
    energy and area for the first three members, Dirichlet mixes of those three
    for the rest."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    draws = rng.dirichlet(np.full(3, concentration), size=n).astype(np.float32)
    k = min(n, 3)
    draws[:k] = np.eye(3, dtype=np.float32)[:k]
    w = np.zeros((n, 4), np.float32)
    w[:, :3] = draws
    return w


def seed_budgets(seeds: list, spec: dict, g: dict, device) -> tuple[float, float]:
    """The worst seed design's worst-case area and power over the workloads,
    by the reference: every seed starts within the budgets."""
    tech, arch = ({f: torch.as_tensor(np.stack([s[t][f] for s in seeds]), device=device) for f in fields}
                  for t, fields in enumerate(sim.FIELDS))
    _, area, power = sim.evaluate(tech, arch, to_device(g, device), spec)
    return float(area.max()), float(power.max())


def to_device(g: dict, device, dtype=torch.float32) -> dict:
    """A stacked graph's arrays as tensors (float arrays in ``dtype``)."""
    return {f: torch.as_tensor(g[f], device=device).to(dtype if g[f].dtype == np.float32 else torch.int32)
            for f in graphs.DATA_FIELDS}
