"""Plain PyTorch versions of the port's kernels.

They run on whatever device their inputs are on: the CPU tests use them, the
kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  They repeat the arithmetic of their
kernels and are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import popsim_kernel as pk


def affine_scan_reference(decay: float, add: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix of ``s' = decay*s + add_i`` (s0 = 0) along the last
    axis, as a log-step doubling scan; ``reverse`` scans from the end.

    Elements are affine maps (a, b): s -> a*s + b; composing an earlier
    (a1, b1) with a later (a2, b2) gives (a1*a2, a2*b1 + b2).  After the step
    with shift ``d``, position i holds the composition of positions
    ``i-2d+1 .. i``; positions below ``d`` are already complete.
    """
    if reverse:
        return affine_scan_reference(decay, add.flip(-1)).flip(-1)
    a = torch.full_like(add, decay)
    b = add.clone()  # a new tensor even when V <= 1 and no step runs
    v = add.shape[-1]
    d = 1
    while d < v:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], -1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], -1)
        d *= 2
    return b


def _t(x: torch.Tensor, y) -> torch.Tensor:
    """``y`` as a tensor on ``x``'s device (a scalar is filled there, with no
    host copy)."""
    return y if torch.is_tensor(y) else torch.full((), y, dtype=x.dtype, device=x.device)


def _nan_max(x: torch.Tensor, y) -> torch.Tensor:
    return torch.maximum(x, _t(x, y))


def _nan_min(x: torch.Tensor, y) -> torch.Tensor:
    return torch.minimum(x, _t(x, y))


def popsim_reference(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """A loop over the vertices, vectorised over the P candidates, with the
    popsim kernel's exact math and operation order.  Returns [P, OUT_COLS]."""
    c = chw_packed.to(torch.float32)
    g_all = graph_packed.to(torch.float32)
    P = c.shape[0]
    freq = c[:, pk.FREQ]
    cap_gbuf = c[:, pk.CAP_GBUF] * pk.HEADROOM
    # a tensor divisor keeps '/' an IEEE division on the card (a Python-scalar
    # divisor is turned into a multiply by its reciprocal there)
    occ_cap = cap_gbuf / torch.full_like(cap_gbuf, pk.HEADROOM)
    bw, rlat, wlat = c[:, pk.BW], c[:, pk.RLAT], c[:, pk.WLAT]
    re_pb, we_pb = c[:, pk.RE_PB], c[:, pk.WE_PB]
    e_flop, rate = c[:, pk.E_FLOP], c[:, pk.RATE]
    sys_x, sys_y = c[:, pk.SYS_X], c[:, pk.SYS_Y]
    eff = [_nan_max(rate[:, k], 1e-9) * freq for k in range(4)]
    rate_sys = _nan_max(rate[:, pk._SYS], 1e-9)

    zeros = torch.zeros(P, dtype=torch.float32, device=c.device)
    cycles, e_dyn, t_comp_acc, t_mem_acc, t_exp_acc, tiles_acc = (zeros,) * 6
    occupancy, bw_ema = zeros, zeros
    for v in range(g_all.shape[0]):
        g = g_all[v]  # 0-dim views of the row broadcast against the [P] designs
        n_comp = [g[pk.G_COMP.start + k] for k in range(4)]
        n_read = [g[pk.G_READ.start + lv] for lv in range(3)]
        n_write = [g[pk.G_WRITE.start + lv] for lv in range(3)]
        alloc_t, has_main_t = g[pk.G_ALLOC_GBUF], g[pk.G_MAIN_PRESENT]
        M, N, K = (g[pk.G_DIMS.start + i] for i in range(3))

        tiles = _nan_max(torch.ceil(alloc_t / cap_gbuf), 1.0)
        m_t = _nan_max(M / tiles, 1.0)
        waves = torch.ceil(m_t / sys_x) * torch.ceil(_nan_max(N, 1.0) / sys_y)
        cyc_sys_tile = waves * (torch.ceil(_nan_max(K, 1.0)) + sys_x + sys_y)
        ops_sys_tile = n_comp[0] / tiles
        cyc_sys_tile = _nan_max(cyc_sys_tile, ops_sys_tile / rate_sys)
        t_sys = torch.where(ops_sys_tile > 0, tiles * cyc_sys_tile / freq, 0.0)
        t_other = zeros
        for k in range(1, 4):
            t_other = _nan_max(t_other, n_comp[k] / eff[k])
        t_comp = _nan_max(t_other, t_sys)

        t_lvl = [(n_read[lv] + n_write[lv]) / bw[:, lv] * 1.04 for lv in range(3)]
        t_tile_lat = [tiles * (rlat[:, lv] + wlat[:, lv]) for lv in range(3)]
        t_onchip = _nan_max(t_lvl[1] + t_tile_lat[1], t_lvl[0])
        t_main = t_lvl[2] + t_tile_lat[2] * has_main_t

        bw_ok = (bw_ema < pk.HEADROOM).to(torch.float32)
        can_prefetch = ((occupancy + alloc_t / tiles) < cap_gbuf).to(torch.float32) * bw_ok
        hide = _nan_max(can_prefetch, bw_ok)

        t_core = _nan_max(t_comp, t_onchip)
        t_exposed = _nan_max(t_main - hide * t_core, 0.0)
        mass = ((n_comp[0] + n_comp[1]) + n_comp[2]) + n_comp[3]
        mass = mass + ((n_read[0] + n_read[1]) + n_read[2]) + ((n_write[0] + n_write[1]) + n_write[2])
        active = (mass + alloc_t + has_main_t > 0).to(torch.float32)
        t_vertex = tiles * torch.ceil((t_core + t_exposed) * freq / tiles) / freq * active

        t_full = tiles * torch.ceil((t_core + t_main) * freq / tiles) / freq
        used_bw = torch.where(
            t_full > 0,
            (n_read[pk._GBUF] + n_write[pk._GBUF]) / _nan_max(t_full, 1e-30) / bw[:, pk._GBUF],
            0.0,
        )
        bw_ema = 0.8 * bw_ema + 0.2 * _nan_min(_nan_max(used_bw, 0.0), 2.0)
        occupancy = _nan_min(0.5 * occupancy + alloc_t, occ_cap)

        e_mem = zeros
        for lv in range(3):
            e_mem = e_mem + (n_read[lv] * re_pb[:, lv] + n_write[lv] * we_pb[:, lv])
        e_comp = zeros
        for k in range(4):
            e_comp = e_comp + n_comp[k] * e_flop[:, k]

        cycles = cycles + t_vertex * freq
        e_dyn = e_dyn + (e_mem + e_comp)
        t_comp_acc = t_comp_acc + t_comp
        t_mem_acc = t_mem_acc + t_onchip * active
        t_exp_acc = t_exp_acc + t_exposed
        tiles_acc = tiles_acc + tiles * active
    return torch.stack([cycles, e_dyn, t_comp_acc, t_mem_acc, t_exp_acc, tiles_acc, zeros, zeros], -1)
