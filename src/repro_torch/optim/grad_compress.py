"""Error-feedback int8 gradient compression.

Each gradient leaf plus its carried residual is int8-quantized in 256-element
blocks and dequantized; the quantization error is carried to the next step
(EF-SGD).  On one device this is the numerics of the compressed data-parallel
reduction: the reduction itself (the reference's ``compressed_psum``) needs a
device mesh and is the next slice of the port's mesh layer (ROADMAP.md queue
1, item 6b).
"""
from __future__ import annotations

import torch

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
