"""AdamW, with optional int8 block-quantized moment states.

The int8 path stores each moment tensor as int8 codes plus one fp32 scale per
256-element block along the last axis (2 bytes a parameter of moments
instead of 8), with the quadratic code map for the moments.

Against the reference: the update runs in place under ``torch.no_grad()``
(the counterpart of the reference's donated train state, so one copy of a
multi-GB state is kept), a whole leaf at a time as the reference does, with
the float32 moments and the parameter updated in place and each product
taken in the reference's order.  On DTensor leaves (a train state on a mesh)
every rank updates its shards in place; a Q8 moment's scale is laid out as
its parameter without the last dim's split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import tree as tu

BLOCK = 256


# --------------------------------------------------------------------------- #
# int8 block quantization
# --------------------------------------------------------------------------- #


class Q8(NamedTuple):
    codes: torch.Tensor  # int8, original param shape
    scale: torch.Tensor  # fp32, shape[:-1] + (n_blocks,): blocks along the LAST axis

    @property
    def shape(self):
        return self.codes.shape


def is_q8(x) -> bool:
    return isinstance(x, Q8)


def _pad_to_block(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def q8_scale_shape(shape: tuple) -> tuple:
    """Blocks run along the last axis, so the scale keeps the leading dims."""
    if not shape:
        return (1,)
    return tuple(shape[:-1]) + (_pad_to_block(shape[-1]) // BLOCK,)


def q8_quantize(x: torch.Tensor, nonlinear: bool = False) -> Q8:
    """Blockwise absmax int8.  ``nonlinear`` uses the quadratic code map
    (value = sign(c) * (|c|/127)^2 * absmax): finer near zero, for the Adam
    moments whose range within a block is wide."""
    shape = tuple(x.shape) or (1,)
    n = shape[-1]
    padded = _pad_to_block(n)
    xp = x.float().reshape(shape)
    if padded != n:  # (a DTensor leaf pads only where it must)
        xp = F.pad(xp, (0, padded - n))
    xb = xp.reshape(shape[:-1] + (padded // BLOCK, BLOCK))
    scale = xb.abs().amax(-1)  # [..., nb] absmax
    norm = xb / torch.clamp(scale[..., None], min=1e-30)  # in [-1, 1]
    mag = norm.abs().sqrt() if nonlinear else norm.abs()
    codes = (torch.sign(norm) * torch.clamp(torch.round(127.0 * mag), 0, 127)).to(torch.int8)
    codes = codes.reshape(shape[:-1] + (padded,))
    if padded != n:
        codes = codes[..., :n]
    return Q8(codes=codes.reshape(shape), scale=scale)


def q8_dequantize(q: Q8, nonlinear: bool = False) -> torch.Tensor:
    shape = tuple(q.codes.shape) or (1,)
    n = shape[-1]
    padded = _pad_to_block(n)
    cp = q.codes.float().reshape(shape)
    if padded != n:
        cp = F.pad(cp, (0, padded - n))
    cb = cp.reshape(shape[:-1] + (padded // BLOCK, BLOCK))
    mag = cb.abs() / 127.0
    if nonlinear:
        mag = mag * mag
    out = torch.sign(cb) * mag * q.scale[..., None]
    out = out.reshape(shape[:-1] + (padded,))
    return (out[..., :n] if padded != n else out).reshape(q.codes.shape)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_states: bool = False
    schedule: Optional[Any] = None  # callable step -> lr multiplier


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments (float32, or ``Q8`` with ``int8_states``) beside each
    parameter, on its device, and the step count (int32)."""

    def zeros_like_state(p):
        if cfg.int8_states:
            return Q8(codes=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                      scale=torch.zeros(q8_scale_shape(tuple(p.shape)), dtype=torch.float32, device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tu.leaves(params)[0].device
    return {"m": tu.tree_map(zeros_like_state, params), "v": tu.tree_map(zeros_like_state, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(x.float())) for x in tu.leaves(tree)])))


def _like(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` in ``dst``'s DTensor placements (the Q8 scale's last dim is
    replicated where the parameter's is split), else as it is."""
    if isinstance(dst, DTensor) and isinstance(src, DTensor) and src.placements != dst.placements:
        return src.redistribute(dst.device_mesh, dst.placements)
    return src


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step: global-norm clip, bias correction with the float32
    step, decoupled weight decay, ``lr * schedule(step)``.  Updates
    ``params`` and ``state`` in place and returns (params, state,
    {"grad_norm", "lr"})."""
    step = state["step"] + 1
    step_f = step.float()
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else torch.ones((), device=step.device))
    bc1 = 1 - torch.pow(cfg.b1, step_f)
    bc2 = 1 - torch.pow(cfg.b2, step_f)

    flat_p = tu.leaves(params)
    flat_g = tu.leaves(grads)
    flat_m = tu.leaves(state["m"], is_q8)
    flat_v = tu.leaves(state["v"], is_q8)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and moments differ in structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        gb = g.float() * clip
        mf = q8_dequantize(m, nonlinear=True) if is_q8(m) else m
        vf = q8_dequantize(v, nonlinear=True) if is_q8(v) else v
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * gb)  # b1 * m + (1 - b1) * g
        vf.mul_(cfg.b2).add_(((1 - cfg.b2) * gb).mul_(gb))  # b2 * v + (1 - b2) * g * g
        del gb
        delta = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(cfg.eps)).add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
        del delta
        if is_q8(m):
            for dst, val in ((m, mf), (v, vf)):
                q = q8_quantize(val, nonlinear=True)
                dst.codes.copy_(_like(q.codes.reshape(dst.codes.shape), dst.codes))  # a scalar's codes come back as [1]
                dst.scale.copy_(_like(q.scale, dst.scale))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": torch.as_tensor(lr, dtype=torch.float32)}
