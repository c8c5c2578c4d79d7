"""Reference cycle-walker simulator (accuracy/speed baseline).

Stands in for the SCALE-Sim / Timeloop-class tools the paper compares
against (§8.1): an interpreted, per-tile, per-wave stepping simulator with
discrete bank-conflict and burst-quantization effects that the fast
closed-form DSim approximates.  Deliberately written as a Python loop over
numpy scalars — the point is the asymptotic *class* (stepped simulation),
which is what makes such tools slow.

It is the accuracy oracle for the simulator on the card: every field it
reads (of the ConcreteHW and the Graph) is copied to the host as float64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dgen import ConcreteHW
from repro_torch.core.graph import Graph
from repro_torch.core.params import COMP_IDX, MEM_IDX, N_COMP, N_MEM

_GBUF = MEM_IDX["globalBuf"]
_MAIN = MEM_IDX["mainMem"]
_LOCAL = MEM_IDX["localMem"]
_SYS = COMP_IDX["systolicArray"]


def _np(field) -> np.ndarray:
    if torch.is_tensor(field):
        field = field.detach().cpu().numpy()
    return np.asarray(field, dtype=np.float64)


def reference_simulate(chw: ConcreteHW, g: Graph, headroom: float = 0.9) -> dict:
    """Walk the DFG tile-by-tile, wave-by-wave with discrete quantization.

    Returns dict(cycles, runtime, energy) — comparable to DSim output.
    """
    freq = float(_np(chw.frequency))
    cap = _np(chw.capacity)
    bw = _np(chw.mem_bw)
    rlat = _np(chw.read_latency)
    wlat = _np(chw.write_latency)
    re_pb = _np(chw.read_energy_pb)
    we_pb = _np(chw.write_energy_pb)
    e_flop = _np(chw.energy_per_flop)
    rate = _np(chw.flops_per_cycle) * freq
    sx, sy = float(_np(chw.sys_x)), float(_np(chw.sys_y))

    n_comp = _np(g.n_comp)
    n_read = _np(g.n_read)
    n_write = _np(g.n_write)
    n_alloc = _np(g.n_alloc)
    dims = _np(g.dims)

    total_cycles = 0.0
    e_dyn = 0.0
    bw_ema = 0.0
    occupancy = 0.0
    cap_g = cap[_GBUF] * headroom

    for v in range(n_comp.shape[0]):
        alloc = n_alloc[v][_GBUF]
        tiles = max(int(np.ceil(alloc / cap_g)), 1)
        M, N, K = dims[v]
        m_t = max(M / tiles, 1.0)

        # discrete wave stepping for the systolic array: each wave processes
        # a (sx x sy) output tile; waves quantize to whole cycles
        t_cls = np.zeros(N_COMP)
        for c in range(N_COMP):
            ops = n_comp[v][c] / tiles
            if ops <= 0:
                continue
            if c == _SYS:
                waves_m = int(np.ceil(m_t / sx))
                waves_n = int(np.ceil(max(N, 1.0) / sy))
                k_cycles = int(np.ceil(max(K, 1.0)))  # one K-step per cycle
                fill = sx + sy  # pipeline fill/drain per wave
                cyc = waves_m * waves_n * (k_cycles + fill)
                # cap at ideal rate (utilization can't exceed 1)
                cyc = max(cyc, ops / (rate[c] / freq))
                t_cls[c] = cyc / freq
            else:
                t_cls[c] = ops / rate[c]
        t_comp = float(t_cls.max())

        # memory: burst-quantized transfers + per-tile access latency +
        # pseudo-random bank conflicts (deterministic hash of vertex id)
        t_lvl = np.zeros(N_MEM)
        for m in range(N_MEM):
            per_tile = (n_read[v][m] + n_write[v][m]) / tiles
            if per_tile <= 0:
                continue
            burst = 64.0  # bytes per burst
            bursts = np.ceil(per_tile / burst)
            conflict = 1.0 + 0.08 * (((v * 2654435761) >> 16) % 100) / 100.0
            t_lvl[m] = (bursts * burst / bw[m]) * conflict + rlat[m] + wlat[m]
        t_onchip = max(t_lvl[_GBUF], t_lvl[_LOCAL])
        t_main = t_lvl[_MAIN]

        # paper Alg. 7: prefetch when space+bw available, STREAMING when over
        # capacity but bw available — either way main-memory time hides
        # whenever the bandwidth EMA has headroom
        can_hide = bw_ema < headroom
        tile_t = max(t_comp / 1.0, t_onchip)
        exposed = max(t_main - (tile_t if can_hide else 0.0), 0.0)
        t_vertex = tiles * (tile_t + exposed)

        # integer-cycle quantization per tile (cycle-walker behaviour)
        cyc_v = tiles * int(np.ceil((tile_t + exposed) * freq))
        total_cycles += cyc_v

        used_bw = (n_read[v][_GBUF] + n_write[v][_GBUF]) / max(t_vertex, 1e-30) / bw[_GBUF]
        bw_ema = 0.8 * bw_ema + 0.2 * min(used_bw, 2.0)
        occupancy = min(0.5 * occupancy + alloc, cap[_GBUF])

        e_dyn += float(np.sum(n_read[v] * re_pb) + np.sum(n_write[v] * we_pb))
        e_dyn += float(np.sum(n_comp[v] * e_flop))

    runtime = total_cycles / freq
    leak = float(np.sum(_np(chw.mem_leakage)) + np.sum(_np(chw.comp_leakage)))
    energy = e_dyn + leak * runtime
    return dict(cycles=total_cycles, runtime=runtime, energy=energy)
