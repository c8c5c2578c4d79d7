"""Error-feedback int8 gradient compression for the data-parallel reduction.

Each gradient leaf plus its carried residual is int8-quantized in 256-element
blocks and dequantized; the quantization error is carried to the next step
(EF-SGD), which keeps convergence within noise of the uncompressed baseline.
:func:`compressed_psum` is the reduction: each rank compresses its own
gradients, then the group takes the mean of the compressed values with one
all-reduce a leaf.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.optim.adamw import q8_dequantize, q8_quantize


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + err) to int8 blocks; return (dequantized, new_err)."""
    target = g.float() + err
    deq = q8_dequantize(q8_quantize(target))
    return deq.to(g.dtype), target - deq


def ef_compress_tree(grads, err_tree):
    """Error-feedback compression leaf by leaf.  Returns (grads', err')."""
    outs = [compress_decompress(g, e) for g, e in zip(tu.leaves(grads), tu.leaves(err_tree))]
    return (tu.unflatten_like(grads, [o[0] for o in outs]), tu.unflatten_like(grads, [o[1] for o in outs]))


def init_error_buffer(params):
    return tu.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_psum(grads, axis_name: str, err_tree, mesh=None):
    """Each rank's gradients (plain tensors, this rank's own) EF-compressed
    with ``err_tree``, then averaged over the ranks of mesh dim ``axis_name``
    (the default process group when ``mesh`` is None).  Returns
    ``(mean, err')``: the mean equal on every rank of the group, the
    residual this rank's own.

    The mean is the sum over the group (one ``SUM`` all-reduce a leaf, on
    gloo and NCCL alike) divided by the group's size.  What crosses the
    links is the dequantized values in the gradient's dtype (4 bytes an
    element for float32 gradients), not the int8 codes and their block
    scales: the quantization error is what is compressed, not the traffic."""
    cg, err = ef_compress_tree(grads, err_tree)
    group = None if mesh is None else mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def mean(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()  # a leaf whose last dim is not a whole number of blocks comes back a slice
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)  # in place: x is compress_decompress's own
        return x / n

    return tu.tree_map(mean, cg), err
