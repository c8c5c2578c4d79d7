"""Per-rank FLOP and byte counts of an eager torch program, by op class.

The reference walks the compiled per-device HLO.  An eager program has none,
so :func:`program_costs` counts the program as it runs, under a dispatch mode
(:class:`CostTracer`) that sees every op a rank executes on its own tensors:

  * on DTensors the mode steps aside (it returns ``NotImplemented``), DTensor
    redistributes and unwraps, and the mode then sees the local op on the
    local shards, and each collective DTensor issues.  So the counts are
    per rank, not the global shapes a mode at the top would see; the ops
    DTensor runs on fake tensors to propagate shapes are not counted;
  * ``dot`` (mm/bmm/addmm/baddbmm): 2 x the products' multiply-adds, from
    ``torch.utils.flop_counter``'s formulas; ``elementwise``: one per output
    element; ``reduce``: one per input element; ``layout`` (casts, copies),
    ``slice`` (index, gather, scatter, cat, pad) and ``collective``: bytes
    only;
  * each hand-written kernel's op is a class of its own (``flash_attention``,
    ``ssd_chunk_scan``, ``selective_scan`` and their states and backward
    ops), its FLOPs from a formula registered with
    ``torch.utils.flop_counter.register_flop_formula`` (the kernels'
    ``operations`` counts; a backward op as a multiple of its forward's);
  * bytes: each op reads its inputs and writes its outputs once (an eager op
    is one kernel: nothing fuses); a collective moves 2 x its output, as the
    reference charges it; views and allocations are free.

Outputs: dict(flops, bytes, flops_by_op, bytes_by_op) — per rank.  The tracer
also records every collective (``hlo_stats``), the peak of live bytes the
traced ops allocated, and the layer loops the model noted.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch import instrument
from repro_torch.kernels.flash_attention import operations as attention_operations
from repro_torch.kernels.sscan import selective_scan_operations
from repro_torch.kernels.ssd import operations as ssd_operations
from repro_torch.models import layers as _layers  # noqa: F401  (registers chunked_attention_backward)

_ops = torch.ops.repro_torch

# --------------------------------------------------------------------------- #
# the kernels' FLOP formulas
# --------------------------------------------------------------------------- #

# the backward ops' multiples of their forward's count: attention's recomputes
# the scores twice (log-sum-exp, then P) and takes four more products (dV,
# dP, dQ, dK) against the forward's two; the scans' are a closed-form pass,
# a carry and a recompute, about twice the forward
ATTENTION_BACKWARD = 3.0
SCAN_BACKWARD = 2.0


@register_flop_formula(_ops.flash_attention)
def _attention_flops(q, k, v, causal, scale, out_shape=None, **_):
    B, Hq, Sq, D = q
    return attention_operations(B, Hq, Sq, k[2], D, causal)


@register_flop_formula(_ops.chunked_attention_backward)
def _attention_backward_flops(q, k, v, out, do, causal, scale, block_q, block_k, out_shape=None, **_):
    B, Hq, Sq, D = q
    return int(ATTENTION_BACKWARD * attention_operations(B, Hq, Sq, k[2], D, causal))


@register_flop_formula([_ops.ssd_chunk_scan, _ops.ssd_chunk_scan_states])
def _ssd_flops(x, dt, A, Bm, Cm, out_shape=None, **_):
    Bt, S, H, P = x
    return ssd_operations(Bt, S, H, P, Bm[-1])


@register_flop_formula(_ops.ssd_chunk_scan_backward)
def _ssd_backward_flops(x, dt, A, Bm, Cm, entering, g_y, g_state, out_shape=None, **_):
    Bt, S, H, P = x
    return int(SCAN_BACKWARD * ssd_operations(Bt, S, H, P, Bm[-1]))


@register_flop_formula([_ops.selective_scan, _ops.selective_scan_states])
def _selective_flops(u, dt, A, Bm, Cm, D, out_shape=None, **_):
    Bt, S, C = u
    return selective_scan_operations(Bt, S, C, A[1])


@register_flop_formula(_ops.selective_scan_backward)
def _selective_backward_flops(u, dt, A, Bm, Cm, D, entering, g_y, g_state, out_shape=None, **_):
    Bt, S, C = u
    return int(SCAN_BACKWARD * selective_scan_operations(Bt, S, C, A[1]))


# --------------------------------------------------------------------------- #
# op classes
# --------------------------------------------------------------------------- #

KERNEL_CLASSES = {
    "flash_attention": "flash_attention",
    "chunked_attention_backward": "flash_attention_backward",
    "ssd_chunk_scan": "ssd_chunk_scan",
    "ssd_chunk_scan_states": "ssd_chunk_scan",
    "ssd_chunk_scan_backward": "ssd_chunk_scan_backward",
    "selective_scan": "selective_scan",
    "selective_scan_states": "selective_scan",
    "selective_scan_backward": "selective_scan_backward",
}
_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm", "convolution", "_convolution"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "_softmax", "_log_softmax",
           "_softmax_backward_data", "_log_softmax_backward_data", "var", "var_mean", "std", "norm",
           "linalg_vector_norm", "cumsum", "cumprod", "topk", "sort", "argmax", "argmin", "any", "all", "prod"}
_LAYOUT = {"_to_copy", "copy_", "clone", "contiguous", "_copy_from", "copy"}
_SLICE = {"index", "index_put", "index_put_", "_index_put_impl_", "gather", "scatter", "scatter_", "scatter_add",
          "scatter_add_", "index_select", "embedding", "embedding_dense_backward", "cat", "stack",
          "constant_pad_nd", "slice_scatter", "select_scatter", "index_add", "index_add_", "masked_scatter",
          "repeat", "repeat_interleave", "one_hot", "narrow_copy", "flip", "roll", "diagonal_scatter",
          "_unsafe_index", "_unsafe_index_put", "masked_select", "nonzero"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "lift_fresh_copy", "_assert_async", "set_", "resize_", "_has_compatible_shallow_copy_type",
         "wait_tensor", "_wrap_tensor_autograd", "record_stream", "_pin_memory", "is_pinned", "_nested_tensor_from_mask"}
COLLECTIVES = {"all_reduce", "all_reduce_", "all_gather_into_tensor", "all_gather_into_tensor_out",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast", "broadcast_",
               "all_gather_into_tensor_coalesced", "reduce_scatter_tensor_coalesced", "all_reduce_coalesced",
               "all_reduce_coalesced_"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _in_propagation(args) -> bool:
    """An op DTensor runs on fake tensors to propagate shapes, not a rank's work."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in _tensors(args))


class CostTracer(TorchDispatchMode):
    """The dispatch mode behind :func:`program_costs`: per-rank FLOPs and
    bytes by op class, every collective, and the peak of live bytes."""

    def __init__(self):
        super().__init__()
        self.flops: dict = defaultdict(float)
        self.bytes: dict = defaultdict(float)
        self.collectives: list[dict] = []  # hlo_stats reads these
        self.live = 0
        self.peak = 0
        self._groups: dict = {}

    # ------------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first; its local ops come back here
        out = func(*args, **kwargs)
        if not _in_propagation(args):
            self._count(func, args, kwargs, out)
        return out

    def _group(self, name: str) -> tuple:
        """(size, global ranks) of the process group named ``name``."""
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            pg = _resolve_process_group(name)
            self._groups[name] = (pg.size(), tuple(dist.get_process_group_ranks(pg)))
        return self._groups[name]

    def _track(self, outs) -> None:
        """Add each new output's bytes to the live total until it is freed."""
        for t in outs:
            n = t.numel() * t.element_size()
            if n == 0:
                continue
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if ns == "_c10d_functional" and name in COLLECTIVES:
            size, ranks = self._group(args[-1])
            for t in outs:
                self.collectives.append({"kind": _kind(name), "bytes": t.numel() * t.element_size(),
                                         "dtype": t.dtype, "group_size": size, "ranks": ranks})
            self.bytes["collective"] += 2.0 * _nbytes(outs)
            self._track(outs)
            return
        if name in _FREE or ns == "_c10d_functional" or getattr(func, "is_view", False):
            return
        if ns == "repro_torch":
            cls = KERNEL_CLASSES.get(name, name)
            self.flops[cls] += self._formula(func, args, kwargs, out)
        elif name in _DOT:
            cls = "dot"
            self.flops[cls] += self._formula(func, args, kwargs, out)
        elif name in _REDUCE:
            cls = "reduce"
            self.flops[cls] += sum(t.numel() for t in ins[:1])
        elif name in _LAYOUT:
            cls = "layout"
        elif name in _SLICE:
            cls = "slice"
        else:
            cls = "elementwise"
            self.flops[cls] += sum(t.numel() for t in outs[:1])
        self.bytes[cls] += _nbytes(ins) + _nbytes(outs)
        self._track(t for t in outs if not any(t is i for i in ins))  # an in-place op allocates nothing

    @staticmethod
    def _formula(func, args, kwargs, out) -> float:
        f = flop_registry.get(func._overloadpacket)
        return float(f(*args, **kwargs, out_val=out)) if f is not None else 0.0

    # ------------------------------------------------------------------ #
    def costs(self) -> dict:
        return {
            "flops": float(sum(self.flops.values())),
            "bytes": float(sum(self.bytes.values())),
            "flops_by_op": {k: float(v) for k, v in self.flops.items()},
            "bytes_by_op": {k: float(v) for k, v in self.bytes.items()},
        }


def _kind(name: str) -> str:
    """The reference's collective kind of a functional collective."""
    if name.startswith("all_reduce"):
        return "all-reduce"
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if name.startswith("all_to_all"):
        return "all-to-all"
    return "collective-permute"  # broadcast: one copy over each link, as a permute


class Trace:
    """What :func:`trace` saw: the tracer's counts, the program's result and
    the layer loops it noted (``instrument.note_loop``)."""

    def __init__(self, tracer: CostTracer, result, loops: list):
        self.tracer, self.result, self.loops = tracer, result, loops

    def costs(self) -> dict:
        return self.tracer.costs()

    @property
    def collectives(self) -> list[dict]:
        return self.tracer.collectives

    @property
    def peak_bytes(self) -> int:
        return self.tracer.peak


def trace(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostTracer`."""
    tracer = CostTracer()
    with instrument.record_loops() as loops, tracer:
        result = fn(*args, **kwargs)
    return Trace(tracer, result, loops)


def program_costs(fn, *args, **kwargs) -> dict:
    """dict(flops, bytes, flops_by_op, bytes_by_op) of one run of ``fn``, per rank."""
    return trace(fn, *args, **kwargs).costs()
