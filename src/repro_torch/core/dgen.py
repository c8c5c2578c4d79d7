"""DGen — the hardware model generator (paper §5.1).

Derives a differentiable hardware model H from
  * an architectural specification (ArchSpec: which units, which memory tech),
  * the device performance-model library (per memory technology, per logic
    primitive), and
  * the accelerator template library (systolicArray / vector / macTree / fpu).

``specialize`` applies concrete parameter assignments and returns a
ConcreteHW of metric values — the paper's CH — which DSim and the mapper
consume.  Everything is differentiable w.r.t. both parameter sets.

Every formula works on leading batch axes: a parameter field of shape
[..., N_MEM] (or [...] for a scalar field) gives ConcreteHW fields with the
same leading axes, which is how a population of designs is specialized at
once.

Device models are CACTI-flavoured closed forms anchored at a 40 nm reference
(paper Alg. 6 uses reference tables at 40 nm): smooth, monotone, plausibly
scaled performance models.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import instrument
from repro_torch.core.params import (
    MEM_TYPES,
    N_MEM,
    ArchParams,
    ArchSpec,
    TechParams,
    TensorTree,
    const,
    max_const,
)

# --------------------------------------------------------------------------- #
# Device library constants (reference @ 40nm), per memory technology
# order: (sram, rram, dram)
# --------------------------------------------------------------------------- #

_WRITE_LAT_MULT = np.array([1.0, 3.0, 1.2], np.float32)
_WRITE_EN_MULT = np.array([1.0, 8.0, 1.1], np.float32)
_PERIPH_DELAY_REF = np.array([0.25e-9, 0.35e-9, 2.0e-9], np.float32)  # s @40nm
_PERIPH_OVERHEAD = np.array([0.35, 0.25, 0.15], np.float32)  # area overhead frac
_LEAK_PERIPH_REF = np.array([2.0e-3, 1.5e-3, 0.5e-3], np.float32)  # W/mm^2 @40nm
_VDD = 0.9  # volts, fixed; node-dependence folded into energy refs

# logic primitive reference values @40nm: (adder, mult, ff)
_PRIM_DELAY = np.array([0.15e-9, 0.60e-9, 0.05e-9], np.float32)  # s
_PRIM_ENERGY = np.array([0.03e-12, 0.80e-12, 0.01e-12], np.float32)  # J
_PRIM_AREA = np.array([60.0, 800.0, 10.0], np.float32)  # um^2
_LEAK_LOGIC_REF = 4.0e-3  # W/mm^2 @40nm


@dataclass
class ConcreteHW(TensorTree):
    """The concrete hardware model CH (paper §3): every metric resolved to a
    real value.  Mem arrays are [..., N_MEM], comp arrays are [..., N_COMP]."""

    # memory metrics
    read_latency: torch.Tensor  # s
    write_latency: torch.Tensor  # s
    read_energy_pb: torch.Tensor  # J / byte
    write_energy_pb: torch.Tensor  # J / byte
    mem_leakage: torch.Tensor  # W
    mem_area: torch.Tensor  # mm^2
    mem_bw: torch.Tensor  # bytes / s
    capacity: torch.Tensor  # bytes
    # compute metrics
    flops_per_cycle: torch.Tensor  # FLOP / cycle per compute class
    energy_per_flop: torch.Tensor  # J / FLOP
    comp_leakage: torch.Tensor  # W
    comp_area: torch.Tensor  # mm^2
    # utilization-model unit dims (systolic rows/cols; lane width)
    sys_x: torch.Tensor
    sys_y: torch.Tensor
    vect_width: torch.Tensor
    # SoC
    frequency: torch.Tensor  # Hz (effective, timing-feasible)

    @property
    def total_area(self) -> torch.Tensor:
        return torch.sum(self.mem_area, -1) + torch.sum(self.comp_area, -1)

    @property
    def total_leakage(self) -> torch.Tensor:
        return torch.sum(self.mem_leakage, -1) + torch.sum(self.comp_leakage, -1)


# --------------------------------------------------------------------------- #
# Memory device models: memLib : MemTypes x MemMetrics -> Exprs  (paper §5.1)
# --------------------------------------------------------------------------- #


def _mem_metrics(tech: TechParams, arch: ArchParams, type_w: torch.Tensor,
                 local_ports_scale: torch.Tensor) -> dict:
    """Memory metrics for all N_MEM units.

    ``type_w``: [N_MEM, 3] technology-selection weights per memory unit
    (one-hot for a concrete ArchSpec; soft for DOpt2's differentiable
    technology selection).
    ``local_ports_scale``: localMem (register files / PE scratchpads) is
    *distributed* — aggregate bandwidth scales with the number of PEs.
    """
    cap = tech.cell_area
    bits = arch.capacity * 8.0
    bank_bits = arch.bank_size * 8.0
    n_banks = max_const(bits / bank_bits, 1.0)

    # geometry: square bank, side in um
    side = torch.sqrt(bank_bits * tech.cell_area)
    global_wire = torch.sqrt(n_banks) * side  # routing across the bank grid

    # distributed RC (fF/um * ohm/um * um^2 -> s; 1e-15 from fF)
    rc_bank = 0.5 * tech.mem_wire_resist * tech.mem_wire_cap * 1e-15 * side**2
    rc_global = 0.5 * tech.mem_wire_resist * tech.mem_wire_cap * 1e-15 * global_wire**2

    node_ratio = tech.peripheral_node / const(cap, 40.0)
    periph_delay = (type_w @ const(cap, _PERIPH_DELAY_REF)) * node_ratio
    cell_lat = tech.cell_read_latency / max_const(tech.cell_access_device, 1e-3)

    read_latency = cell_lat + rc_bank + rc_global + periph_delay
    write_latency = read_latency * (type_w @ const(cap, _WRITE_LAT_MULT))

    # energy per byte: cell read + wire charge (8 bits/byte); the wire term
    # grows with the sqrt of the bandwidth fabric — neutral at bw_scale = 1
    bw_scale = max_const(arch.bw_scale, 1e-3)
    wire_e_bit = tech.mem_wire_cap * (side + global_wire) * 1e-15 * _VDD**2 * torch.sqrt(bw_scale)
    cell_e_bit = tech.cell_read_power * 1e-12
    read_energy_pb = 8.0 * (cell_e_bit + wire_e_bit)
    write_energy_pb = read_energy_pb * (type_w @ const(cap, _WRITE_EN_MULT))

    # area: cells + peripheral overhead (smaller peripheral node -> less
    # overhead) + the wider port/wire fabric bought by bw_scale
    overhead = (type_w @ const(cap, _PERIPH_OVERHEAD)) * node_ratio
    fabric = 1.0 + 0.10 * (bw_scale - 1.0)
    mem_area = bits * tech.cell_area * 1e-6 * (1.0 + overhead) * fabric  # mm^2

    # leakage: cells + peripheral logic
    leak_cells = tech.cell_leakage_power * 1e-9 * bits
    leak_periph = (type_w @ const(cap, _LEAK_PERIPH_REF)) * mem_area * overhead * torch.sqrt(
        const(cap, 40.0) / tech.peripheral_node
    )
    mem_leakage = leak_cells + leak_periph

    # bandwidth: each port streams one bank row per access; localMem ports
    # replicate with the PE fabric (one port per 8 MACs)
    row_bytes = torch.sqrt(bank_bits) / 8.0
    lps = local_ports_scale.unsqueeze(-1)
    port_scale = torch.cat([lps, torch.ones(lps.shape[:-1] + (N_MEM - 1,), device=lps.device)], -1)
    mem_bw = arch.n_read_ports * port_scale * row_bytes / read_latency * bw_scale

    return dict(
        read_latency=read_latency,
        write_latency=write_latency,
        read_energy_pb=read_energy_pb,
        write_energy_pb=write_energy_pb,
        mem_leakage=mem_leakage,
        mem_area=mem_area,
        mem_bw=mem_bw,
        capacity=arch.capacity,
    )


# --------------------------------------------------------------------------- #
# Logic primitive models: primLib : PrimitiveType x CompMetrics -> XExprs
# --------------------------------------------------------------------------- #


def _prim(tech_node: torch.Tensor, which: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(delay s, energy J, area um^2) for primitive ``which`` at ``node`` nm.

    Delay scales ~linearly with node, energy/area ~quadratically.
    """
    s = tech_node / const(tech_node, 40.0)
    return (float(_PRIM_DELAY[which]) * s, float(_PRIM_ENERGY[which]) * s**2,
            float(_PRIM_AREA[which]) * s**2)


# --------------------------------------------------------------------------- #
# Accelerator template library: accTempls (paper §5.1)
# --------------------------------------------------------------------------- #


def _comp_metrics(tech: TechParams, arch: ArchParams) -> dict:
    node = tech.node  # [..., N_COMP]
    add_d, add_e, add_a = _prim(node, 0)
    mul_d, mul_e, mul_a = _prim(node, 1)
    ff_d, ff_e, ff_a = _prim(node, 2)

    # wire adder per PE: RC over the PE's own extent
    pe_side = torch.sqrt(mul_a + add_a + 3 * ff_a)  # um
    wire_d = 0.5 * tech.comp_wire_resist * tech.comp_wire_cap * 1e-15 * pe_side**2
    wire_e = tech.comp_wire_cap * pe_side * 1e-15 * _VDD**2

    # per-class unit counts and per-MAC composition
    sys_macs = arch.sys_arr_x * arch.sys_arr_y * arch.sys_arr_n
    vect_macs = arch.vect_width * arch.vect_n
    mtree_macs = arch.mtree_x * arch.mtree_y * arch.mtree_tile_x * arch.mtree_tile_y
    fpu_macs = arch.fpu_n

    macs = torch.stack(torch.broadcast_tensors(sys_macs, vect_macs, mtree_macs, fpu_macs), -1)
    flops_per_cycle = 2.0 * macs  # 1 MAC = 2 FLOPs

    # cycle-limiting path per class: systolic PE is mult+ff (pipelined),
    # vector lane mult+add (FMA), mac tree mult + log-depth adder stage,
    # fpu a slower multi-stage unit (modelled 2x mult path)
    tree_depth = torch.log2(max_const(arch.mtree_x, 2.0))
    i = lambda x, k: x[..., k]  # noqa: E731
    crit = torch.stack(
        torch.broadcast_tensors(
            i(mul_d, 0) + i(ff_d, 0) + i(wire_d, 0),
            i(mul_d, 1) + i(add_d, 1) + i(wire_d, 1),
            i(mul_d, 2) + i(add_d, 2) * 1.0 + i(wire_d, 2) * tree_depth,
            2.0 * (i(mul_d, 3) + i(add_d, 3)),
        ),
        -1,
    )

    # energy per MAC (J): mult + add + pipeline regs + wires
    e_mac = torch.stack(
        [
            i(mul_e, 0) + i(add_e, 0) + 3 * i(ff_e, 0) + i(wire_e, 0),
            i(mul_e, 1) + i(add_e, 1) + 2 * i(ff_e, 1) + i(wire_e, 1),
            i(mul_e, 2) + i(add_e, 2) + i(ff_e, 2) + i(wire_e, 2),
            2.0 * (i(mul_e, 3) + i(add_e, 3)) + 4 * i(ff_e, 3),
        ],
        -1,
    )
    energy_per_flop = e_mac / 2.0

    # area mm^2: PEs + 20% routing/control overhead
    a_mac = torch.stack(
        [
            i(mul_a, 0) + i(add_a, 0) + 3 * i(ff_a, 0),
            i(mul_a, 1) + i(add_a, 1) + 2 * i(ff_a, 1),
            i(mul_a, 2) + i(add_a, 2) + i(ff_a, 2),
            4.0 * (i(mul_a, 3) + i(add_a, 3)),
        ],
        -1,
    )
    comp_area = macs * a_mac * 1e-6 * 1.2

    # leakage: per-area density improves (shrinks) slowly with node
    comp_leakage = _LEAK_LOGIC_REF * comp_area * torch.sqrt(const(node, 40.0) / node)

    return dict(
        flops_per_cycle=flops_per_cycle,
        energy_per_flop=energy_per_flop,
        comp_leakage=comp_leakage,
        comp_area=comp_area,
        crit_path=crit,
    )


# --------------------------------------------------------------------------- #
# specialize: H x TA x AA -> CH  (paper §3)
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=64)
def _spec_arrays(spec: ArchSpec, device: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(one-hot memory-technology weights, mem mask, comp mask) of a spec,
    copied to ``device`` once (one ``dgen.spec_arrays`` build)."""
    instrument.count_trace("dgen.spec_arrays")
    one_hot = np.eye(len(MEM_TYPES), dtype=np.float32)[spec.mem_type_idx()]
    return tuple(torch.as_tensor(a, device=device) for a in (one_hot, spec.mem_mask(), spec.comp_mask()))


def specialize(
    tech: TechParams,
    arch: ArchParams,
    spec: ArchSpec = ArchSpec(),
    type_weights: torch.Tensor | None = None,
) -> ConcreteHW:
    """Evaluate the hardware model into concrete metrics.

    ``type_weights`` overrides the spec's hard memory-technology selection
    with soft weights [N_MEM, 3] (used by DOpt2's differentiable technology
    search); default is the one-hot encoding of ``spec.mem_type``.  Traced,
    span ``dgen.specialize``.
    """
    dev = tech.node.device
    with instrument.span("dgen.specialize", dev):
        one_hot, mem_mask, comp_mask = _spec_arrays(spec, str(dev))
        tw = one_hot if type_weights is None else type_weights

        comp = _comp_metrics(tech, arch)
        total_macs = torch.sum(comp["flops_per_cycle"], -1) / 2.0
        mem = _mem_metrics(tech, arch, tw, max_const(total_macs / 8.0, 1.0))

        # timing feasibility: the SoC clock cannot beat the slowest critical path
        slowest = torch.amax(torch.where(comp_mask > 0, comp["crit_path"], 0.0), -1)
        f_max = const(slowest, 1.0) / slowest
        frequency = torch.minimum(arch.frequency, f_max)

        return ConcreteHW(
            read_latency=mem["read_latency"],
            write_latency=mem["write_latency"],
            read_energy_pb=mem["read_energy_pb"],
            write_energy_pb=mem["write_energy_pb"],
            mem_leakage=mem["mem_leakage"] * mem_mask,
            mem_area=mem["mem_area"] * mem_mask,
            mem_bw=mem["mem_bw"],
            capacity=mem["capacity"],
            flops_per_cycle=comp["flops_per_cycle"] * comp_mask,
            energy_per_flop=comp["energy_per_flop"],
            comp_leakage=comp["comp_leakage"] * comp_mask,
            comp_area=comp["comp_area"] * comp_mask,
            sys_x=arch.sys_arr_x,
            sys_y=arch.sys_arr_y,
            vect_width=arch.vect_width,
            frequency=frequency,
        )
