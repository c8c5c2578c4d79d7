"""The plain reference of the simulator: DGen, the mapper, DSim and the
population's DOpt step, in plain PyTorch.

A frozen copy of the simulator's mathematics as it stood when the benchmark
was defined (paper §5-§7): the hardware model generator's closed forms
(``specialize``), the mapper's per-vertex tiling, compute and memory times,
prefetch and streaming gates and cycle quantisation (Algorithms 1, 2, 7), with
its two inter-vertex carries, the decaying buffer occupancy and the bandwidth
EMA, taken by a sequential loop over the vertices; DSim's runtime, energy,
area and power; the mixed log objective with its smooth budget penalty; and
one epoch of the population's log-space Adam with bounds clamping and the
per-member rollback of a non-finite step.  Gradients come from autograd
through all of it, the sequential carries included.

It imports nothing of the program.  Trees are dicts of tensors keyed by field
name; a population's leaves carry a leading member axis [P, ...].  Every
function computes in the dtype of the tensors it is given, so the same code,
handed bfloat16 tensors, is the lower-precision control.
"""
from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# parameter spaces (paper Table 2): field -> per-member shape, and the bounds
# --------------------------------------------------------------------------- #

N_MEM, N_COMP = 3, 4
MEM_TYPES = ("sram", "rram", "dram")
MEM_CLS = ("localMem", "globalBuf", "mainMem")
COMP_CLS = ("systolicArray", "vector", "macTree", "fpu")
_LOCAL, _GBUF, _MAIN = 0, 1, 2
_SYS = 0

TECH_FIELDS = {
    "mem_wire_cap": (N_MEM,), "mem_wire_resist": (N_MEM,), "cell_read_latency": (N_MEM,),
    "cell_access_device": (N_MEM,), "cell_read_power": (N_MEM,), "cell_leakage_power": (N_MEM,),
    "cell_area": (N_MEM,), "peripheral_node": (N_MEM,), "comp_wire_cap": (N_COMP,),
    "comp_wire_resist": (N_COMP,), "node": (N_COMP,),
}
ARCH_FIELDS = {
    "sys_arr_x": (), "sys_arr_y": (), "sys_arr_n": (), "vect_width": (), "vect_n": (), "mtree_x": (),
    "mtree_y": (), "mtree_tile_x": (), "mtree_tile_y": (), "fpu_n": (), "frequency": (),
    "capacity": (N_MEM,), "bank_size": (N_MEM,), "n_read_ports": (N_MEM,), "bw_scale": (N_MEM,),
}

TECH_LO = dict(
    mem_wire_cap=[0.02] * N_MEM, mem_wire_resist=[0.1] * N_MEM, cell_read_latency=[0.01e-9, 0.05e-9, 1e-9],
    cell_access_device=[0.25] * N_MEM, cell_read_power=[2e-4, 5e-4, 0.05], cell_leakage_power=[1e-6] * N_MEM,
    cell_area=[0.01, 0.005, 1e-4], peripheral_node=[3.0] * N_MEM, comp_wire_cap=[0.02] * N_COMP,
    comp_wire_resist=[0.1] * N_COMP, node=[3.0] * N_COMP,
)
TECH_HI = dict(
    mem_wire_cap=[1.0] * N_MEM, mem_wire_resist=[10.0] * N_MEM, cell_read_latency=[5e-9, 5e-9, 100e-9],
    cell_access_device=[4.0] * N_MEM, cell_read_power=[0.05, 0.2, 20.0], cell_leakage_power=[0.05] * N_MEM,
    cell_area=[2.0, 1.0, 0.05], peripheral_node=[90.0] * N_MEM, comp_wire_cap=[1.0] * N_COMP,
    comp_wire_resist=[10.0] * N_COMP, node=[90.0] * N_COMP,
)
ARCH_LO = dict(
    sys_arr_x=4.0, sys_arr_y=4.0, sys_arr_n=1.0, vect_width=8.0, vect_n=1.0, mtree_x=4.0, mtree_y=1.0,
    mtree_tile_x=1.0, mtree_tile_y=1.0, fpu_n=1.0, frequency=0.2e9, capacity=[2**16, 2**20, 2**30],
    bank_size=[2**12, 2**14, 2**19], n_read_ports=[1.0, 1.0, 1.0], bw_scale=[0.25, 0.25, 0.25],
)
ARCH_HI = dict(
    sys_arr_x=1024.0, sys_arr_y=1024.0, sys_arr_n=64.0, vect_width=4096.0, vect_n=128.0, mtree_x=1024.0,
    mtree_y=256.0, mtree_tile_x=64.0, mtree_tile_y=64.0, fpu_n=512.0, frequency=3e9,
    capacity=[64 * 2**20, 512 * 2**20, 256 * 2**30], bank_size=[2**20, 2**23, 2**26],
    n_read_ports=[64.0, 64.0, 64.0], bw_scale=[16.0, 16.0, 16.0],
)
FIELDS = (TECH_FIELDS, ARCH_FIELDS)
BOUNDS = ((TECH_LO, TECH_HI), (ARCH_LO, ARCH_HI))


def float32_numerics() -> None:
    """Full float32 products on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bounds(device, dtype=torch.float32) -> tuple:
    """((tech lo, tech hi), (arch lo, arch hi)) as dicts of tensors."""
    def tree(d):
        return {f: torch.as_tensor(np.asarray(v, np.float32), device=device).to(dtype) for f, v in d.items()}
    return tuple((tree(lo), tree(hi)) for lo, hi in BOUNDS)


def const(like: torch.Tensor, value) -> torch.Tensor:
    """A constant as a tensor of ``like``'s dtype and device (a tensor
    divisor keeps '/' a true division on the card)."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=like.device).to(like.dtype)
    return torch.full((), value, dtype=like.dtype, device=like.device)


def max_const(x, value):
    return torch.maximum(x, const(x, value))


def _tmap(fn, *trees):
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


# --------------------------------------------------------------------------- #
# DGen: specialize (paper §5.1)
# --------------------------------------------------------------------------- #

_WRITE_LAT_MULT = np.array([1.0, 3.0, 1.2], np.float32)
_WRITE_EN_MULT = np.array([1.0, 8.0, 1.1], np.float32)
_PERIPH_DELAY_REF = np.array([0.25e-9, 0.35e-9, 2.0e-9], np.float32)
_PERIPH_OVERHEAD = np.array([0.35, 0.25, 0.15], np.float32)
_LEAK_PERIPH_REF = np.array([2.0e-3, 1.5e-3, 0.5e-3], np.float32)
_VDD = 0.9
_PRIM_DELAY = np.array([0.15e-9, 0.60e-9, 0.05e-9], np.float32)
_PRIM_ENERGY = np.array([0.03e-12, 0.80e-12, 0.01e-12], np.float32)
_PRIM_AREA = np.array([60.0, 800.0, 10.0], np.float32)
_LEAK_LOGIC_REF = 4.0e-3


def spec_arrays(spec: dict, like: torch.Tensor) -> tuple:
    """(one-hot memory-technology weights [N_MEM, 3], mem mask, comp mask)."""
    idx = [MEM_TYPES.index(t) for t in spec["mem_type"]]
    one_hot = np.eye(len(MEM_TYPES), dtype=np.float32)[idx]
    mem_mask = np.array([1.0 if m in spec["mem_units"] else 0.0 for m in MEM_CLS], np.float32)
    comp_mask = np.array([1.0 if c in spec["comp_units"] else 0.0 for c in COMP_CLS], np.float32)
    return tuple(const(like, a) for a in (one_hot, mem_mask, comp_mask))


def _mem_metrics(tech, arch, type_w, local_ports_scale) -> dict:
    cap = tech["cell_area"]
    bits = arch["capacity"] * 8.0
    bank_bits = arch["bank_size"] * 8.0
    n_banks = max_const(bits / bank_bits, 1.0)
    side = torch.sqrt(bank_bits * tech["cell_area"])
    global_wire = torch.sqrt(n_banks) * side
    rc_bank = 0.5 * tech["mem_wire_resist"] * tech["mem_wire_cap"] * 1e-15 * side**2
    rc_global = 0.5 * tech["mem_wire_resist"] * tech["mem_wire_cap"] * 1e-15 * global_wire**2
    node_ratio = tech["peripheral_node"] / const(cap, 40.0)
    periph_delay = (type_w @ const(cap, _PERIPH_DELAY_REF)) * node_ratio
    cell_lat = tech["cell_read_latency"] / max_const(tech["cell_access_device"], 1e-3)
    read_latency = cell_lat + rc_bank + rc_global + periph_delay
    write_latency = read_latency * (type_w @ const(cap, _WRITE_LAT_MULT))
    bw_scale = max_const(arch["bw_scale"], 1e-3)
    wire_e_bit = tech["mem_wire_cap"] * (side + global_wire) * 1e-15 * _VDD**2 * torch.sqrt(bw_scale)
    cell_e_bit = tech["cell_read_power"] * 1e-12
    read_energy_pb = 8.0 * (cell_e_bit + wire_e_bit)
    write_energy_pb = read_energy_pb * (type_w @ const(cap, _WRITE_EN_MULT))
    overhead = (type_w @ const(cap, _PERIPH_OVERHEAD)) * node_ratio
    fabric = 1.0 + 0.10 * (bw_scale - 1.0)
    mem_area = bits * tech["cell_area"] * 1e-6 * (1.0 + overhead) * fabric
    leak_cells = tech["cell_leakage_power"] * 1e-9 * bits
    leak_periph = (type_w @ const(cap, _LEAK_PERIPH_REF)) * mem_area * overhead * torch.sqrt(
        const(cap, 40.0) / tech["peripheral_node"])
    row_bytes = torch.sqrt(bank_bits) / 8.0
    lps = local_ports_scale.unsqueeze(-1)
    port_scale = torch.cat([lps, torch.ones(lps.shape[:-1] + (N_MEM - 1,), dtype=lps.dtype, device=lps.device)], -1)
    mem_bw = arch["n_read_ports"] * port_scale * row_bytes / read_latency * bw_scale
    return dict(read_latency=read_latency, write_latency=write_latency, read_energy_pb=read_energy_pb,
                write_energy_pb=write_energy_pb, mem_leakage=leak_cells + leak_periph, mem_area=mem_area,
                mem_bw=mem_bw, capacity=arch["capacity"])


def _prim(node, which: int):
    s = node / const(node, 40.0)
    return (float(_PRIM_DELAY[which]) * s, float(_PRIM_ENERGY[which]) * s**2, float(_PRIM_AREA[which]) * s**2)


def _comp_metrics(tech, arch) -> dict:
    node = tech["node"]
    add_d, add_e, add_a = _prim(node, 0)
    mul_d, mul_e, mul_a = _prim(node, 1)
    ff_d, ff_e, ff_a = _prim(node, 2)
    pe_side = torch.sqrt(mul_a + add_a + 3 * ff_a)
    wire_d = 0.5 * tech["comp_wire_resist"] * tech["comp_wire_cap"] * 1e-15 * pe_side**2
    wire_e = tech["comp_wire_cap"] * pe_side * 1e-15 * _VDD**2
    sys_macs = arch["sys_arr_x"] * arch["sys_arr_y"] * arch["sys_arr_n"]
    vect_macs = arch["vect_width"] * arch["vect_n"]
    mtree_macs = arch["mtree_x"] * arch["mtree_y"] * arch["mtree_tile_x"] * arch["mtree_tile_y"]
    macs = torch.stack(torch.broadcast_tensors(sys_macs, vect_macs, mtree_macs, arch["fpu_n"]), -1)
    tree_depth = torch.log2(max_const(arch["mtree_x"], 2.0))
    i = lambda x, k: x[..., k]  # noqa: E731
    crit = torch.stack(torch.broadcast_tensors(
        i(mul_d, 0) + i(ff_d, 0) + i(wire_d, 0),
        i(mul_d, 1) + i(add_d, 1) + i(wire_d, 1),
        i(mul_d, 2) + i(add_d, 2) * 1.0 + i(wire_d, 2) * tree_depth,
        2.0 * (i(mul_d, 3) + i(add_d, 3)),
    ), -1)
    e_mac = torch.stack([
        i(mul_e, 0) + i(add_e, 0) + 3 * i(ff_e, 0) + i(wire_e, 0),
        i(mul_e, 1) + i(add_e, 1) + 2 * i(ff_e, 1) + i(wire_e, 1),
        i(mul_e, 2) + i(add_e, 2) + i(ff_e, 2) + i(wire_e, 2),
        2.0 * (i(mul_e, 3) + i(add_e, 3)) + 4 * i(ff_e, 3),
    ], -1)
    a_mac = torch.stack([
        i(mul_a, 0) + i(add_a, 0) + 3 * i(ff_a, 0),
        i(mul_a, 1) + i(add_a, 1) + 2 * i(ff_a, 1),
        i(mul_a, 2) + i(add_a, 2) + i(ff_a, 2),
        4.0 * (i(mul_a, 3) + i(add_a, 3)),
    ], -1)
    comp_area = macs * a_mac * 1e-6 * 1.2
    return dict(flops_per_cycle=2.0 * macs, energy_per_flop=e_mac / 2.0,
                comp_leakage=_LEAK_LOGIC_REF * comp_area * torch.sqrt(const(node, 40.0) / node),
                comp_area=comp_area, crit_path=crit)


def specialize(tech: dict, arch: dict, spec: dict) -> dict:
    """The concrete hardware model: every metric of every unit, as a dict."""
    one_hot, mem_mask, comp_mask = spec_arrays(spec, tech["node"])
    comp = _comp_metrics(tech, arch)
    total_macs = torch.sum(comp["flops_per_cycle"], -1) / 2.0
    mem = _mem_metrics(tech, arch, one_hot, max_const(total_macs / 8.0, 1.0))
    slowest = torch.amax(torch.where(comp_mask > 0, comp["crit_path"], 0.0), -1)
    frequency = torch.minimum(arch["frequency"], const(slowest, 1.0) / slowest)
    return dict(
        read_latency=mem["read_latency"], write_latency=mem["write_latency"],
        read_energy_pb=mem["read_energy_pb"], write_energy_pb=mem["write_energy_pb"],
        mem_leakage=mem["mem_leakage"] * mem_mask, mem_area=mem["mem_area"] * mem_mask, mem_bw=mem["mem_bw"],
        capacity=mem["capacity"], flops_per_cycle=comp["flops_per_cycle"] * comp_mask,
        energy_per_flop=comp["energy_per_flop"], comp_leakage=comp["comp_leakage"] * comp_mask,
        comp_area=comp["comp_area"] * comp_mask, sys_x=arch["sys_arr_x"], sys_y=arch["sys_arr_y"],
        frequency=frequency,
    )


# --------------------------------------------------------------------------- #
# the mapper (paper §5.2, Algorithms 1/2/7), carries by a sequential loop
# --------------------------------------------------------------------------- #

HEADROOM = 0.9
OCC_DECAY, BW_DECAY, BW_GAIN = 0.5, 0.8, 0.2


def ste(hard, soft):
    """Forward the discrete value, differentiate the smooth one."""
    return soft + (hard - soft).detach()


def ceil_ste(x):
    return ste(torch.ceil(x), x)


def gate_below_ste(x, thresh, tau: float = 0.1):
    if not torch.is_tensor(thresh):
        thresh = const(x, thresh)
    hard = (x < thresh).to(x.dtype)
    soft = torch.sigmoid((thresh - x) / (tau * torch.abs(thresh) + 1e-30))
    return ste(hard, soft)


def _clip(x, lo, hi):
    return torch.minimum(max_const(x, lo), const(x, hi))


def carries(alloc, bw_x, cap):
    """The two Alg.-7 carries before each vertex, one vertex at a time:
    occupancy ``o' = min(0.5 o + alloc, cap)`` and bandwidth EMA
    ``b' = 0.8 b + 0.2 x``, both 0 before the first vertex."""
    lead = torch.broadcast_shapes(alloc.shape[:-1], bw_x.shape[:-1], cap.shape)
    occ = torch.zeros(lead, dtype=bw_x.dtype, device=bw_x.device)
    bw = torch.zeros(lead, dtype=bw_x.dtype, device=bw_x.device)
    occ_prev, bw_prev = [], []
    for v in range(bw_x.shape[-1]):
        occ_prev.append(occ)
        bw_prev.append(bw)
        occ = torch.minimum(OCC_DECAY * occ + alloc[..., v], cap)
        bw = BW_DECAY * bw + BW_GAIN * bw_x[..., v]
    return torch.stack(occ_prev, -1), torch.stack(bw_prev, -1)


def map_workload(chw: dict, g: dict) -> dict:
    """Cycles and the traffic and compute totals of each workload (the graph
    arrays carry a leading workload axis; the hardware a [P, 1] lead)."""
    freq = chw["frequency"][..., None]
    cap = chw["capacity"][..., _GBUF, None]
    bw = chw["mem_bw"][..., None, :]
    lat = (chw["read_latency"] + chw["write_latency"])[..., None, :]
    fpc = chw["flops_per_cycle"][..., None, :]
    sys_x, sys_y = chw["sys_x"][..., None], chw["sys_y"][..., None]
    cap_gbuf = cap * HEADROOM

    alloc_gbuf = g["n_alloc"][..., _GBUF]
    tiles = max_const(ceil_ste(alloc_gbuf / cap_gbuf), 1.0)
    M, N, K = g["dims"][..., 0], g["dims"][..., 1], g["dims"][..., 2]
    m_t = max_const(M / tiles, 1.0)
    waves_m = ceil_ste(m_t / sys_x)
    waves_n = ceil_ste(max_const(N, 1.0) / sys_y)
    k_cycles = ceil_ste(max_const(K, 1.0))
    cyc_sys_tile = waves_m * waves_n * (k_cycles + (sys_x + sys_y))
    ops_sys_tile = g["n_comp"][..., _SYS] / tiles
    cyc_sys_tile = torch.maximum(cyc_sys_tile, ops_sys_tile / max_const(fpc[..., _SYS], 1e-9))
    t_sys = torch.where(ops_sys_tile > 0, tiles * cyc_sys_tile / freq, 0.0)
    eff_rate = max_const(fpc, 1e-9) * freq[..., None]
    t_comp_cls = g["n_comp"] / eff_rate
    t_other = torch.cat([torch.zeros_like(t_comp_cls[..., :1]), t_comp_cls[..., 1:]], -1)
    t_comp = torch.maximum(torch.amax(t_other, -1), t_sys)

    t_lvl = (g["n_read"] + g["n_write"]) / bw * 1.04  # 1.04: the walker's mean bank-conflict factor
    t_tile_lat = tiles[..., None] * lat
    t_onchip = torch.maximum(t_lvl[..., _GBUF] + t_tile_lat[..., _GBUF], t_lvl[..., _LOCAL])
    t_main = t_lvl[..., _MAIN] + t_tile_lat[..., _MAIN] * (g["n_alloc"][..., _MAIN] > 0)
    t_core = torch.maximum(t_comp, t_onchip)

    t_full = tiles * ceil_ste((t_core + t_main) * freq / max_const(tiles, 1.0)) / freq
    bytes_gbuf = g["n_read"][..., _GBUF] + g["n_write"][..., _GBUF]
    used_bw = torch.where(t_full > 0, bytes_gbuf / max_const(t_full, 1e-30) / bw[..., _GBUF], 0.0)
    bw_x = _clip(used_bw, 0.0, 2.0)
    active = ((torch.sum(g["n_comp"], -1) + torch.sum(g["n_read"], -1) + torch.sum(g["n_write"], -1)
               + torch.sum(g["n_alloc"], -1)) > 0).to(bw_x.dtype)

    occ_prev, bw_prev = carries(alloc_gbuf, bw_x, chw["capacity"][..., _GBUF])

    can_prefetch = (gate_below_ste(occ_prev + alloc_gbuf / tiles, cap * HEADROOM)
                    * gate_below_ste(bw_prev, HEADROOM))
    can_stream = gate_below_ste(bw_prev, HEADROOM)
    hide = torch.maximum(can_prefetch, can_stream)
    t_main_exposed = max_const(t_main - hide * t_core, 0.0)
    per_tile_cyc = (t_core + t_main_exposed) * freq / tiles
    t_vertex = tiles * ceil_ste(per_tile_cyc) / freq * active
    cycles_v = t_vertex * freq
    return dict(cycles=torch.sum(cycles_v, -1), reads=torch.sum(g["n_read"], -2),
                writes=torch.sum(g["n_write"], -2), comp_ops=torch.sum(g["n_comp"], -2))


# --------------------------------------------------------------------------- #
# DSim (paper §5.3) and the multi-objective layer
# --------------------------------------------------------------------------- #


def simulate(tech: dict, arch: dict, g: dict, spec: dict) -> dict:
    """Runtime, energy, power and area of each (member, workload) pair."""
    chw = specialize(tech, arch, spec)
    ms = map_workload(chw, g)
    runtime = ms["cycles"] / chw["frequency"]
    e_mem = torch.sum(ms["reads"] * chw["read_energy_pb"] + ms["writes"] * chw["write_energy_pb"], -1)
    e_comp = torch.sum(ms["comp_ops"] * chw["energy_per_flop"], -1)
    leak = torch.sum(chw["mem_leakage"], -1) + torch.sum(chw["comp_leakage"], -1)
    energy = e_mem + e_comp + leak * runtime
    area = (torch.sum(chw["mem_area"], -1) + torch.sum(chw["comp_area"], -1)).expand(runtime.shape)
    return dict(runtime=runtime, energy=energy, power=energy / max_const(runtime, 1e-30), area=area,
                edp=energy * runtime)


def log_metrics(perfs: dict) -> torch.Tensor:
    """[..., 4] mean log (time, energy, area, edp) over the workload axis."""
    return torch.stack([torch.mean(torch.log(perfs[k]), -1) for k in ("runtime", "energy", "area", "edp")], -1)


def budget_penalty(perfs: dict, area_budget, power_budget, sharpness: float = 8.0):
    viol_area = torch.log(torch.amax(perfs["area"], -1)) - torch.log(area_budget)
    viol_power = torch.log(torch.amax(perfs["power"], -1)) - torch.log(power_budget)
    sp = lambda v: torch.logaddexp(sharpness * v, torch.zeros_like(v)) / sharpness  # noqa: E731
    return sp(viol_area) + sp(viol_power)


def against_workloads(tree: dict) -> dict:
    """[P, ...] member leaves as [P, 1, ...], to broadcast against [W, ...]."""
    return {k: x.unsqueeze(1) for k, x in tree.items()}


def evaluate(tech: dict, arch: dict, g: dict, spec: dict) -> tuple:
    """A design sweep's answer: [P, 4] log metrics, and each design's
    worst-case area [P] and power [P] over the workloads."""
    with torch.no_grad():
        perfs = simulate(against_workloads(tech), against_workloads(arch), g, spec)
        return log_metrics(perfs), torch.amax(perfs["area"], -1), torch.amax(perfs["power"], -1)


# --------------------------------------------------------------------------- #
# the population's DOpt epoch (paper §7): log-space Adam, clamp, rollback
# --------------------------------------------------------------------------- #

B1, B2, EPS = 0.9, 0.999, 1e-8


def to_log(tree: dict) -> dict:
    return {k: torch.log(torch.maximum(x, torch.full_like(x, 1e-30))) for k, x in tree.items()}


def init_state(tech: dict, arch: dict) -> dict:
    """Log-space parameters and zero Adam moments; one step count a member."""
    z = (to_log(tech), to_log(arch))
    p = next(iter(tech.values())).shape[0]
    return dict(z=z, m=tuple(_tmap(torch.zeros_like, t) for t in z), v=tuple(_tmap(torch.zeros_like, t) for t in z),
                step=torch.zeros((p,), dtype=torch.int32, device=next(iter(tech.values())).device))


def _per_member(x, leaf):
    return x.reshape(x.shape + (1,) * (leaf.ndim - x.ndim))


def population_step(state: dict, mixes: tuple, g: dict, spec: dict, lr, penalty_w, log_bounds) -> tuple:
    """One epoch of every member.  Returns (state', row [P, 5], grads): the row
    is [value, log time, log energy, log area, log edp]; grads are the
    members' gradients (tech, arch) before Adam."""
    weights, area_budget, power_budget = mixes
    zt, za = (_tmap(lambda x: x.detach().requires_grad_(True), t) for t in state["z"])
    with torch.enable_grad():
        perfs = simulate(against_workloads(_tmap(torch.exp, zt)), against_workloads(_tmap(torch.exp, za)), g, spec)
        logm = log_metrics(perfs)
        val = torch.sum(weights * logm, -1) + penalty_w * budget_penalty(perfs, area_budget, power_budget)
        wrt = list(zt.values()) + list(za.values())
        grads = torch.autograd.grad(val.sum(), wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(wrt, grads)]
    val = val.detach()
    ok = torch.isfinite(val)
    for gr in grads:
        ok = ok & torch.isfinite(gr).reshape(gr.shape[0], -1).all(1)
    it = iter(grads)
    gt = {k: next(it) for k in zt}
    ga = {k: next(it) for k in za}

    step = state["step"] + 1
    stepf = step.to(val.dtype)
    c1 = 1 - torch.pow(torch.full_like(stepf, B1), stepf)
    c2 = 1 - torch.pow(torch.full_like(stepf, B2), stepf)
    new_z, new_m, new_v = [], [], []
    for z, m, v, gr, (lo, hi) in zip(state["z"], state["m"], state["v"], (gt, ga), log_bounds):
        m = _tmap(lambda m_, g_: B1 * m_ + (1 - B1) * g_, m, gr)
        v = _tmap(lambda v_, g_: B2 * v_ + (1 - B2) * g_ * g_, v, gr)
        upd = _tmap(lambda m_, v_: -lr * (m_ / _per_member(c1, m_)) / (torch.sqrt(v_ / _per_member(c2, v_)) + EPS),
                    m, v)
        z = _tmap(lambda p, u: p + u, z, upd)
        z = _tmap(lambda x, lo_, hi_: torch.minimum(torch.maximum(x, lo_), hi_), z, lo, hi)
        new_z.append(z)
        new_m.append(m)
        new_v.append(v)

    def keep(new, old):
        return torch.where(_per_member(ok, new), new, old)

    out = dict(z=tuple(_tmap(keep, n, o) for n, o in zip(new_z, state["z"])),
               m=tuple(_tmap(keep, n, o) for n, o in zip(new_m, state["m"])),
               v=tuple(_tmap(keep, n, o) for n, o in zip(new_v, state["v"])),
               step=keep(step, state["step"]))
    row = torch.cat([val[:, None], logm.detach()], -1)
    return out, row, (gt, ga)


def log_bounds(device, dtype=torch.float32) -> tuple:
    return tuple((to_log(lo), to_log(hi)) for lo, hi in bounds(device, dtype))
