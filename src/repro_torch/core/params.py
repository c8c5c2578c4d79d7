"""DRAGON parameter spaces (paper Table 2), as dataclasses of tensors.

TechParams  — technology parameters (MemTechPars + CompTechPars)
ArchParams  — architectural parameters (MemArchPars + CompArchPars)

Every field is a positive float32 tensor, so the whole simulator is
differentiable with respect to them.  Integer-valued parameters (node,
capacities, array dims, ...) are carried as floats and rounded
straight-through at the point of use (see mapper.py / dgen.py).

:class:`TensorTree` gives these dataclasses (and ConcreteHW, MapState,
PerfEstimate) the few tree operations the port needs: ``map`` over fields,
``flatten`` into one vector, and ``from_numpy`` from a dict of arrays keyed
by field name.

Unit conventions (kept consistent across dgen/dsim):
  time    seconds        energy  joules        power  watts
  area    mm^2           length  micrometers   bytes  bytes
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

# Class universes (paper §3)
MEM_CLS = ("localMem", "globalBuf", "mainMem")
COMP_CLS = ("systolicArray", "vector", "macTree", "fpu")
MEM_TYPES = ("sram", "rram", "dram")
PRIMITIVES = ("adder", "mult", "ff")

N_MEM = len(MEM_CLS)
N_COMP = len(COMP_CLS)

MEM_IDX = {m: i for i, m in enumerate(MEM_CLS)}
COMP_IDX = {c: i for i, c in enumerate(COMP_CLS)}


class TensorTree:
    """Tree helpers for a dataclass whose fields are tensors (or trees)."""

    def leaves(self) -> list[torch.Tensor]:
        out = []
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            out.extend(x.leaves() if isinstance(x, TensorTree) else [x])
        return out

    def map(self, fn, *others):
        """Apply ``fn`` field-wise across this tree and ``others`` (same type)."""
        kw = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            rest = [getattr(o, f.name) for o in others]
            kw[f.name] = x.map(fn, *rest) if isinstance(x, TensorTree) else fn(x, *rest)
        return type(self)(**kw)

    def flatten(self) -> torch.Tensor:
        return torch.cat([x.reshape(-1) if x.ndim else x.reshape(1) for x in self.leaves()])

    def to(self, device):
        return self.map(lambda x: x.to(device))

    @classmethod
    def from_numpy(cls, d, device=None):
        """Build from float32 arrays keyed by field name: a dict, or any
        object that holds them as attributes (the reference package's tree of
        the same name).  Leaves keep their shapes, so a [P]-stacked tree
        converts to a [P]-stacked tree."""
        dev = resolve_device(device)
        get = d.__getitem__ if isinstance(d, Mapping) else functools.partial(getattr, d)
        return cls(**{
            f.name: torch.tensor(np.array(get(f.name), np.float32), device=dev)
            for f in dataclasses.fields(cls)
        })


_CONSTS: dict = {}


def const(like: torch.Tensor, value) -> torch.Tensor:
    """A float32 constant on ``like``'s device.  A tensor operand keeps '/'
    an IEEE division on the card (a Python-scalar divisor becomes a multiply
    by its reciprocal there) and gives torch.maximum/minimum their second
    operand.  Scalars are filled on the device; numpy arrays are copied once
    per device and cached, so no optimizer step waits on a host copy."""
    if isinstance(value, np.ndarray):
        key = (id(value), str(like.device))
        if key not in _CONSTS:
            _CONSTS[key] = torch.as_tensor(value, dtype=torch.float32, device=like.device)
        return _CONSTS[key]
    return torch.full((), value, dtype=torch.float32, device=like.device)


def max_const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``jnp.maximum(x, value)``: NaN-propagating, gradient split on ties."""
    return torch.maximum(x, const(x, value))


def _f(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclass
class TechParams(TensorTree):
    """Technology parameters.  Mem fields are [N_MEM] (per memory unit);
    comp fields are [N_COMP] (per compute unit)."""

    # --- MemTechPars (paper Table 2) ---
    mem_wire_cap: torch.Tensor  # fF / um of wire
    mem_wire_resist: torch.Tensor  # ohm / um of wire
    cell_read_latency: torch.Tensor  # s, intrinsic cell sensing latency
    cell_access_device: torch.Tensor  # relative access-device strength (1.0 = ref)
    cell_read_power: torch.Tensor  # pJ / bit dynamic read
    cell_leakage_power: torch.Tensor  # nW / bit standby leakage
    cell_area: torch.Tensor  # um^2 / bit
    peripheral_node: torch.Tensor  # nm, peripheral logic node
    # --- CompTechPars ---
    comp_wire_cap: torch.Tensor  # fF / um
    comp_wire_resist: torch.Tensor  # ohm / um
    node: torch.Tensor  # nm, logic node per compute class

    @staticmethod
    def default(device=None) -> "TechParams":
        """40nm-reference technology point (paper Alg. 6: 'table at 40nm').

        localMem / globalBuf default to SRAM-like cells, mainMem to DRAM.
        """
        d = resolve_device(device)
        return TechParams(
            mem_wire_cap=_f([0.20, 0.20, 0.25], d),
            mem_wire_resist=_f([1.2, 1.2, 2.0], d),
            cell_read_latency=_f([0.15e-9, 0.50e-9, 12e-9], d),
            cell_access_device=_f([1.0, 1.0, 1.0], d),
            cell_read_power=_f([0.004, 0.010, 2.0], d),  # pJ/bit (dram incl. I/O)
            cell_leakage_power=_f([1.0e-3, 0.8e-3, 0.02e-3], d),  # nW/bit
            cell_area=_f([0.30, 0.15, 0.0030], d),  # um^2/bit
            peripheral_node=_f([40.0, 40.0, 40.0], d),
            comp_wire_cap=_f([0.20] * N_COMP, d),
            comp_wire_resist=_f([1.2] * N_COMP, d),
            node=_f([40.0] * N_COMP, d),
        )

    @staticmethod
    def bounds(device=None) -> tuple["TechParams", "TechParams"]:
        """Realistic lower/upper bounds (paper Alg. 6 step 5)."""
        d = resolve_device(device)
        lo = TechParams(
            mem_wire_cap=_f([0.02] * N_MEM, d),
            mem_wire_resist=_f([0.1] * N_MEM, d),
            cell_read_latency=_f([0.01e-9, 0.05e-9, 1e-9], d),
            cell_access_device=_f([0.25] * N_MEM, d),
            cell_read_power=_f([2e-4, 5e-4, 0.05], d),
            cell_leakage_power=_f([1e-6] * N_MEM, d),
            cell_area=_f([0.01, 0.005, 1e-4], d),
            peripheral_node=_f([3.0] * N_MEM, d),
            comp_wire_cap=_f([0.02] * N_COMP, d),
            comp_wire_resist=_f([0.1] * N_COMP, d),
            node=_f([3.0] * N_COMP, d),
        )
        hi = TechParams(
            mem_wire_cap=_f([1.0] * N_MEM, d),
            mem_wire_resist=_f([10.0] * N_MEM, d),
            cell_read_latency=_f([5e-9, 5e-9, 100e-9], d),
            cell_access_device=_f([4.0] * N_MEM, d),
            cell_read_power=_f([0.05, 0.2, 20.0], d),
            cell_leakage_power=_f([0.05] * N_MEM, d),
            cell_area=_f([2.0, 1.0, 0.05], d),
            peripheral_node=_f([90.0] * N_MEM, d),
            comp_wire_cap=_f([1.0] * N_COMP, d),
            comp_wire_resist=_f([10.0] * N_COMP, d),
            node=_f([90.0] * N_COMP, d),
        )
        return lo, hi


@dataclass
class ArchParams(TensorTree):
    """Architectural parameters (design-time tunable)."""

    # systolic array
    sys_arr_x: torch.Tensor  # PE rows
    sys_arr_y: torch.Tensor  # PE cols
    sys_arr_n: torch.Tensor  # number of arrays
    # vector unit
    vect_width: torch.Tensor  # lanes
    vect_n: torch.Tensor  # units
    # mac tree
    mtree_x: torch.Tensor
    mtree_y: torch.Tensor
    mtree_tile_x: torch.Tensor
    mtree_tile_y: torch.Tensor
    # fpu
    fpu_n: torch.Tensor
    # SoC
    frequency: torch.Tensor  # Hz
    # memories: [N_MEM]
    capacity: torch.Tensor  # bytes
    bank_size: torch.Tensor  # bytes
    n_read_ports: torch.Tensor
    # bandwidth provisioning multiplier per level (1.0 = the port-derived
    # baseline); dgen charges wire area and access energy for extra bandwidth
    bw_scale: torch.Tensor

    @staticmethod
    def default(device=None) -> "ArchParams":
        """A TPU-v1-flavoured edge accelerator starting point."""
        d = resolve_device(device)
        return ArchParams(
            sys_arr_x=_f(128.0, d),
            sys_arr_y=_f(128.0, d),
            sys_arr_n=_f(2.0, d),
            vect_width=_f(256.0, d),
            vect_n=_f(4.0, d),
            mtree_x=_f(64.0, d),
            mtree_y=_f(8.0, d),
            mtree_tile_x=_f(8.0, d),
            mtree_tile_y=_f(8.0, d),
            fpu_n=_f(8.0, d),
            frequency=_f(0.94e9, d),
            capacity=_f([4 * 2**20, 24 * 2**20, 16 * 2**30], d),
            bank_size=_f([32 * 2**10, 256 * 2**10, 8 * 2**20], d),
            n_read_ports=_f([16.0, 8.0, 8.0], d),
            bw_scale=_f([1.0, 1.0, 1.0], d),
        )

    @staticmethod
    def bounds(device=None) -> tuple["ArchParams", "ArchParams"]:
        d = resolve_device(device)
        lo = ArchParams(
            sys_arr_x=_f(4.0, d), sys_arr_y=_f(4.0, d), sys_arr_n=_f(1.0, d),
            vect_width=_f(8.0, d), vect_n=_f(1.0, d),
            mtree_x=_f(4.0, d), mtree_y=_f(1.0, d), mtree_tile_x=_f(1.0, d), mtree_tile_y=_f(1.0, d),
            fpu_n=_f(1.0, d), frequency=_f(0.2e9, d),
            capacity=_f([2**16, 2**20, 2**30], d),
            bank_size=_f([2**12, 2**14, 2**19], d),
            n_read_ports=_f([1.0, 1.0, 1.0], d),
            bw_scale=_f([0.25, 0.25, 0.25], d),
        )
        hi = ArchParams(
            sys_arr_x=_f(1024.0, d), sys_arr_y=_f(1024.0, d), sys_arr_n=_f(64.0, d),
            vect_width=_f(4096.0, d), vect_n=_f(128.0, d),
            mtree_x=_f(1024.0, d), mtree_y=_f(256.0, d), mtree_tile_x=_f(64.0, d), mtree_tile_y=_f(64.0, d),
            fpu_n=_f(512.0, d), frequency=_f(3e9, d),
            capacity=_f([64 * 2**20, 512 * 2**20, 256 * 2**30], d),
            bank_size=_f([2**20, 2**23, 2**26], d),
            n_read_ports=_f([64.0, 64.0, 64.0], d),
            bw_scale=_f([16.0, 16.0, 16.0], d),
        )
        return lo, hi


@dataclass(frozen=True)
class ArchSpec:
    """Architectural specification (paper §5.1): which units exist and
    which memory technology backs each memory unit.  Static (no tensors)."""

    mem_units: tuple[str, ...] = MEM_CLS
    comp_units: tuple[str, ...] = COMP_CLS
    mem_type: tuple[str, ...] = ("sram", "sram", "dram")  # per MEM_CLS entry

    def mem_type_idx(self) -> np.ndarray:
        return np.array([MEM_TYPES.index(t) for t in self.mem_type], dtype=np.int32)

    def comp_mask(self) -> np.ndarray:
        return np.array([1.0 if c in self.comp_units else 0.0 for c in COMP_CLS], np.float32)

    def mem_mask(self) -> np.ndarray:
        return np.array([1.0 if m in self.mem_units else 0.0 for m in MEM_CLS], np.float32)


def clamp_params(p, lo, hi):
    """Field-wise clip of ``p`` into ``[lo, hi]``."""
    return p.map(lambda x, lo_, hi_: torch.minimum(torch.maximum(x, lo_), hi_), lo, hi)


def per_member(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``x`` (a scalar, or [P]: one value a member) shaped [P, 1, ...] to
    broadcast against a leaf [P, ...] by its leading (member) axis."""
    return x.reshape(x.shape + (1,) * (leaf.ndim - x.ndim))


def stack_trees(trees: list):
    """One tree whose every leaf stacks the given trees' leaves on a new
    leading (member) axis."""
    return type(trees[0])(**{f.name: torch.stack([getattr(t, f.name) for t in trees])
                             for f in dataclasses.fields(trees[0])})


def from_reference(obj, device=None):
    """The port's counterpart of a value of the reference package, found by
    its type's name: TechParams / ArchParams (any leading axes, so stacked
    populations too), ArchSpec, CompiledArch and Graph; tuples, lists and
    dicts of them; arrays (e.g. random draws) become tensors of their dtype.
    Everything lands on ``device`` (the card unless the caller names another)."""
    name = type(obj).__name__
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_reference(x, device) for x in obj)
    if isinstance(obj, Mapping):
        return {k: from_reference(v, device) for k, v in obj.items()}
    if name in ("TechParams", "ArchParams"):
        return {"TechParams": TechParams, "ArchParams": ArchParams}[name].from_numpy(obj, device)
    if name == "ArchSpec":
        return ArchSpec(**{f.name: tuple(getattr(obj, f.name)) for f in dataclasses.fields(ArchSpec)})
    if name == "CompiledArch":
        from repro_torch.core.dhdl import CompiledArch

        return CompiledArch(name=obj.name, spec=from_reference(obj.spec), arch=from_reference(obj.arch, device),
                            tech=from_reference(obj.tech, device))
    if name == "Graph":
        from repro_torch.core.graph import DATA_FIELDS, Graph

        return Graph.from_numpy({f: np.asarray(getattr(obj, f)) for f in DATA_FIELDS}, obj.names, device)
    return torch.as_tensor(np.array(obj), device=resolve_device(device))

