"""Public kernel wrappers + the popsim packing helpers."""
from __future__ import annotations

import torch

from repro_torch.core.dgen import ConcreteHW
from repro_torch.core.graph import Graph
from repro_torch.kernels import popsim_kernel as pk
from repro_torch.kernels.sscan import affine_scan  # noqa: F401  (re-export)

_SCALAR_FIELDS = ("frequency", "sys_x", "sys_y")


def pack_chw(chw: ConcreteHW) -> torch.Tensor:
    """Pack a ConcreteHW (or a population of them: fields with leading batch
    axes, which broadcast against each other) into the popsim kernel layout
    [P, CHW_COLS]."""
    lead = [getattr(chw, f).shape if f in _SCALAR_FIELDS else getattr(chw, f).shape[:-1]
            for f in ("frequency", "capacity", "mem_bw", "read_latency", "write_latency",
                      "read_energy_pb", "write_energy_pb", "energy_per_flop", "flops_per_cycle",
                      "sys_x", "sys_y")]
    batch = torch.broadcast_shapes(*lead)

    def col(x: torch.Tensor) -> torch.Tensor:  # scalar field -> [..., 1]
        return x.expand(batch)[..., None]

    def vec(x: torch.Tensor) -> torch.Tensor:
        return x.expand(batch + x.shape[-1:])

    parts = [
        col(chw.frequency),
        vec(chw.capacity)[..., pk._GBUF:pk._GBUF + 1],
        vec(chw.mem_bw),
        vec(chw.read_latency),
        vec(chw.write_latency),
        vec(chw.read_energy_pb),
        vec(chw.write_energy_pb),
        vec(chw.energy_per_flop),
        vec(chw.flops_per_cycle),
        col(chw.sys_x),
        col(chw.sys_y),
    ]
    packed = torch.cat(parts, -1).to(torch.float32).reshape(-1, pk.CHW_COLS)
    assert packed.shape[-1] == pk.CHW_COLS, (packed.shape, pk.CHW_COLS)
    return packed


def pack_graph(g: Graph) -> torch.Tensor:
    """Pack a Graph into the popsim kernel layout [V, GRAPH_COLS]."""
    out = torch.cat(
        [
            g.n_comp,
            g.n_read,
            g.n_write,
            g.n_alloc[:, 1:2],
            (g.n_alloc[:, 2:3] > 0).to(torch.float32),
            g.dims,
            torch.zeros_like(g.dims[:, :1]),
        ],
        -1,
    ).to(torch.float32)
    assert out.shape[-1] == pk.GRAPH_COLS, (out.shape, pk.GRAPH_COLS)
    return out.contiguous()


def popsim(graph_packed: torch.Tensor, chw_packed: torch.Tensor) -> torch.Tensor:
    """Evaluate P packed designs against one packed DFG -> [P, OUT_COLS].

    The CUDA kernel spreads each design over 2 to 32 lanes, chosen from P so
    that the grid fills the card, and masks a ragged last block, so any P
    works and no block size needs choosing."""
    return pk.popsim(graph_packed, chw_packed)
