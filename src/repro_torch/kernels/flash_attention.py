"""Attention with grouped KV heads and an online softmax, as hand-written
CUDA kernels.  Forward only.

The op ``torch.ops.repro_torch.flash_attention`` launches a kernel on CUDA
tensors and runs the plain version, ``ref.reference_attention``, on CPU
tensors.  Which kernel is a function of the dtype and the head width alone
(:func:`route`): bf16 at D = 64, 112 (kimi-k2's heads) or 128 goes to the
tensor cores (``csrc/flash_attention_sm90.cu``: wgmma, K/V tiles by TMA);
float32 at every head width from 1 to 256, and bf16 at every other one, to
``csrc/flash_attention.cu`` on the float32 pipes, whose float32 numbers match
the reference's 2e-5 (a tensor-core product in float32 would be TF32).  That
kernel is compiled at three width caps (64, 128, 256) and takes any D up to
each.  Each kernel has its own launch count.  A build or launch failure of the
kernel a call routes to raises: nothing retries on the other kernel.  Both
kernels mask ragged Sq and Skv themselves, so no block size has to divide the
sequence.

On DTensors the op has a sharding rule: q, k, v all replicated, all split
over batch, or all split over heads (each shard holding the KV heads its
query heads read).  The sequence and the head width it needs whole: a
placement there is redistributed to one of those, and each rank launches the
kernel on its shard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import reference_attention

SM90_HEAD_DIMS = (64, 112, 128)  # flash_attention_sm90: bf16 on the tensor cores
MAX_HEAD_DIM = 256  # flash_attention takes every other head width from 1 to this
_DTYPES = (torch.float32, torch.bfloat16)


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel (its ``runtime.LAUNCHES`` key) that attention over ``dtype``
    q, k, v of head width ``D`` launches on the card; raises for a pair no
    kernel takes (a type other than float32 and bfloat16, or D outside 1 to
    ``MAX_HEAD_DIM``)."""
    if dtype not in _DTYPES or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: no kernel for head width {D} in {dtype}: the kernels take "
                         f"float32 and bfloat16 at head widths 1 to {MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS:
        return "flash_attention_sm90"
    return "flash_attention"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B,Hq,Sq,D], k and v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] == 0 or Hq % k.shape[1] or k.shape[2] == 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       scale: float) -> torch.Tensor:
    """The plain version (CPU implementation of the op)."""
    _check(q, k, v)
    return reference_attention(q, k, v, causal=causal, scale=scale).contiguous()


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                          scale: float) -> torch.Tensor:
    _check(q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    B, Hq, Sq, D = q.shape
    name = route(q.dtype, D)
    out = torch.empty_like(q)
    if out.numel() == 0:  # nothing to attend, no launch
        return out
    if name == "flash_attention_sm90" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v at head width 64, 112 or 128 must start on a "
                         "16-byte boundary (TMA reads them)")
    args = (B, Hq, k.shape[1], Sq, k.shape[2], D, int(causal), float(scale))
    lib = runtime.library(name)
    runtime.count_launch(name)
    if name == "flash_attention_sm90":
        err = lib.flash_attention_sm90_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
                                              runtime.stream_handle(q))
    else:
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
                                         int(q.dtype == torch.bfloat16), runtime.stream_handle(q))
    runtime.check_launch(name, err)
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape)


def _sharding(q, k, v, causal, scale):
    from torch.distributed.tensor import Replicate, Shard

    return [([p], [p, p, p, None, None]) for p in (Replicate(), Shard(0), Shard(1))]


def _register_sharding() -> None:
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.flash_attention.default)(_sharding)


_register_sharding()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's type.
    KV head of q head h is ``h // (Hq // Hkv)``; the causal mask is suffix-causal
    with offset ``Skv - Sq``; the scale defaults to ``D ** -0.5``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_attention_op(q.contiguous(), k.contiguous(), v.contiguous(), causal, float(scale))


def operations(B: int, Hq: int, Sq: int, Skv: int, D: int, causal: bool) -> int:
    """Multiply-adds of the two products, counted as two operations each, over
    the (query, key) pairs the mask keeps, plus one exp per kept pair."""
    off = Skv - Sq
    pairs = sum(max(0, min(Skv, i + off + 1)) for i in range(Sq)) if causal else Sq * Skv
    return B * Hq * pairs * (4 * D + 1)
