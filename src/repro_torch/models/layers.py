"""Layers shared by the model zoo (functional, over plain tensors).

Attention has two paths:

  * :func:`attention` — full-sequence attention on [B, S, H, D] tensors,
    through :func:`chunked_attention`: its forward is the hand-written
    attention kernel (``kernels.flash_attention``), its backward a
    flash-style pass over a static list of (q block, kv block) pairs;
  * :func:`decode_attention` — one query against a KV cache, plain PyTorch.

On a device mesh the tensors are DTensors: the kernel's op and the
backward's op each carry a sharding rule (batch and heads), so each rank runs
them on its shard; :func:`attention` hands a shard of query heads the KV heads
it reads (:func:`_kv_heads_for`), and :func:`write_at` writes each rank's
rows of a sharded cache in place.

``mm`` needs no backward of its own: autograd of a bf16 ``einsum`` keeps the
cotangent in bf16 with fp32 accumulation, which is what the reference's
explicit ``_mm_vjp`` does.

Layout: activations are [B, S, d_model]; per-head tensors are [B, S, H, D]
(transposed to [B, H, S, D] only inside attention).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import instrument
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.sharding import einsum, is_dtensor, reshape, unsplit

NEG_INF = -1e30  # finite mask bias: keeps every softmax intermediate finite


def mm(subscripts: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product with the weight cast to the activation dtype: bf16 operands,
    fp32 accumulation (the card's and the CPU's bf16 products accumulate in
    fp32), output in the activation dtype.  On DTensors each rank multiplies
    its shards (``sharding.einsum``)."""
    return einsum(subscripts, x, w.to(x.dtype))


# --------------------------------------------------------------------------- #
# norms / rope / mlp
# --------------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # on a mesh the features gathered first (the products after the norm want
    # them whole); a mean over split features leaves partial averages, which
    # DTensor may scatter over the sequence
    xf = unsplit(x, -1).float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def mlp_act(gate: torch.Tensor, up: Optional[torch.Tensor], kind: str) -> torch.Tensor:
    """swiglu (silu in float32), gelu (the tanh approximation, in the gate's
    dtype, as ``jax.nn.gelu``) or relu2 (``relu(gate) ** 2``)."""
    if kind == "swiglu":
        return F.silu(gate.float()).to(gate.dtype) * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "relu2":
        r = F.relu(gate)
        return r * r
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #


def write_at(cache: torch.Tensor, lens: torch.Tensor, x: torch.Tensor) -> None:
    """``cache[b, lens[b]] = x[b]`` in place, for every b with lens[b] inside
    the cache; a write past its end is dropped (no index leaves the cache)."""
    if is_dtensor(cache):
        _write_at_sharded(cache, lens, x)
        return
    bidx = torch.arange(cache.shape[0], device=cache.device)
    idx = lens.clamp(max=cache.shape[1] - 1)
    keep = (lens < cache.shape[1]).reshape((-1,) + (1,) * (x.ndim - 1))
    cache[bidx, idx] = torch.where(keep, x.to(cache.dtype), cache[bidx, idx])


def _write_at_sharded(cache, lens, x) -> None:
    """:func:`write_at` on a DTensor cache [B, M, ...]: each rank writes, in
    its local shard, the rows of the batch it holds at the positions it
    holds (the cache's sequence dim may be split: the long-context decode)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = cache.device_mesh, cache.placements
    seq_split = [i for i, p in enumerate(pl) if p == Shard(1)]
    # x [B, ...] laid out as the cache without its sequence dim; lens as its batch
    xpl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2 else (p if p == Shard(0) else Replicate())
           for p in pl]
    lpl = [p if p == Shard(0) else Replicate() for p in pl]

    def local(t, placements):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    x_loc, lens_loc = local(x, xpl), local(lens, lpl)
    loc = cache.to_local()
    off, size, coord = 0, cache.shape[1], mesh.get_coordinate()
    for i in seq_split:  # nested in mesh-dim order, as DTensor splits
        size //= mesh.size(i)
        off += coord[i] * size
    pos = lens_loc - off
    M = loc.shape[1]
    keep = ((pos >= 0) & (pos < M)).reshape((-1,) + (1,) * (x_loc.ndim - 1))
    bidx = torch.arange(loc.shape[0], device=loc.device)
    idx = pos.clamp(0, M - 1)
    loc[bidx, idx] = torch.where(keep, x_loc.to(loc.dtype), loc[bidx, idx])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, 1, D] against a padded cache k, v [B, Hkv, Skv, D]; positions
    at or past ``cache_len`` ([B] or a scalar) are masked out."""
    B, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qg = reshape(q, B, Hkv, group, D)
    s = einsum("bhgd,bhkd->bhgk", qg.float(), k.float()) * scale
    valid = torch.arange(Skv, device=q.device)[None, None, None, :] < cache_len.reshape(-1, 1, 1, 1)
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    out = einsum("bhgk,bhkd->bhgd", p, v.float())
    return reshape(out, B, Hq, 1, D).to(q.dtype)


# --------------------------------------------------------------------------- #
# chunked attention: the kernel forward, a flash-style backward
# --------------------------------------------------------------------------- #


def _pick_block(S: int, target: int) -> int:
    """Largest divisor of S that is <= target."""
    b = min(target, S)
    while S % b:
        b -= 1
    return b


def _kv_blocks(Skv: int, block_k: int) -> tuple[int, int]:
    """(kv block, padded kv length).  When Skv has no usable divisor (the
    vision model's 1,601 patches are prime) K/V are padded to a multiple of
    ``min(block_k, Skv)`` and the tail is masked, as the reference does."""
    bk = _pick_block(Skv, block_k)
    if bk < min(block_k, 128) and Skv > 128:
        bk = min(block_k, Skv)
        return bk, -(-Skv // bk) * bk
    return bk, Skv


def _causal_pairs(nq: int, nk: int, block_q: int, block_k: int, causal: bool, off: int = 0):
    """Static (qi, kj) block-pair list; causal keeps kj*bk <= qi_end + off."""
    return [(qi, kj) for qi in range(nq) for kj in range(nk)
            if not (causal and kj * block_k > (qi + 1) * block_q - 1 + off)]


def _spans(pairs: list, span: int) -> list[tuple[int, int, int]]:
    """The pair list as (qi, kj0, kj1) runs: consecutive kv blocks of one q
    block, at most ``span`` blocks a run."""
    out = []
    for qi, kj in pairs:
        if out and out[-1][0] == qi and out[-1][2] == kj and kj - out[-1][1] < span:
            out[-1] = (qi, out[-1][1], kj + 1)
        else:
            out.append((qi, kj, kj + 1))
    return out


def _span_bias(qi: int, k0: int, k1: int, bq: int, bk: int, causal: bool, off: int, kv_len: Optional[int],
               device):
    """The [bq, (k1-k0)*bk] mask bias of q block ``qi`` against kv blocks
    k0..k1-1 (0 kept, NEG_INF masked), or None where it masks nothing: the
    causal mask keeps key position ``k <= q + off``; the padded tail of K/V
    starts at ``kv_len``."""
    diag = causal and k1 * bk - 1 > qi * bq + off
    tail = kv_len is not None and k1 * bk > kv_len
    if not (diag or tail):
        return None
    qpos = qi * bq + torch.arange(bq, device=device)[:, None]
    kpos = k0 * bk + torch.arange((k1 - k0) * bk, device=device)[None, :]
    masked = torch.zeros(bq, (k1 - k0) * bk, dtype=torch.bool, device=device)
    if diag:
        masked |= kpos > qpos + off
    if tail:
        masked |= kpos >= kv_len
    return torch.where(masked, NEG_INF, 0.0)


_SLAB = 1 << 26  # float32 scores a run of block pairs may hold (256 MB)


def chunked_attention_bwd(q, k, v, out, do, *, causal: bool, scale: float, block_q: int = 512,
                          block_k: int = 512):
    """The gradients (dq, dk, dv) of attention, flash style, in float32.

    Two passes over the reference's static pair list: the first recomputes
    each query row's log-sum-exp (the kernel returns none), the second
    recomputes ``P = exp(S - lse)`` and accumulates ``dV += P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - Di) scale`` with ``Di = rowsum(dO O)``,
    ``dQ += dS K`` and ``dK += dS^T Q``.  The pairs of one q block with
    consecutive kv blocks run together, up to ``_SLAB`` scores at once, so a
    row of 4,096 keys is a handful of launches, not one set a pair; no
    [B, Hq, Sq, Skv] tensor is made.  The query blocks are laid out as
    [nq, B, Hkv, G*bq, D], so that every product is one batched matmul over
    (B, Hkv) with GQA's group folded into the rows."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    off = Skv - Sq  # the forward's suffix-causal offset
    bq = _pick_block(Sq, block_q)
    bk, Skp = _kv_blocks(Skv, block_k)
    kv_len = Skv if Skp != Skv else None
    nq, nk = Sq // bq, Skp // bk

    def q_blocks(x):  # [B, Hq, Sq, D] -> [nq, B, Hkv, G*bq, D] float32
        return x.float().reshape(B, Hkv, G, nq, bq, D).permute(3, 0, 1, 2, 4, 5).reshape(nq, B, Hkv, G * bq, D)

    qb, dob, ob = q_blocks(q), q_blocks(do), q_blocks(out)
    kf = F.pad(k.float(), (0, 0, 0, Skp - Skv)).contiguous()  # [B, Hkv, Skp, D], the tail zero-padded
    vf = F.pad(v.float(), (0, 0, 0, Skp - Skv)).contiguous()
    di = (dob * ob).sum(-1)  # [nq, B, Hkv, G*bq]
    del ob
    runs = _spans(_causal_pairs(nq, nk, bq, bk, causal, off), max(1, _SLAB // (B * Hq * bq * bk)))

    def scores(qi, k0, k1):
        s = (qb[qi] @ kf[:, :, k0 * bk:k1 * bk].transpose(-1, -2)) * scale  # [B, Hkv, G*bq, n*bk]
        bias = _span_bias(qi, k0, k1, bq, bk, causal, off, kv_len, q.device)
        if bias is not None:
            s = (s.view(B, Hkv, G, bq, -1) + bias).view(B, Hkv, G * bq, -1)
        return s

    m = torch.full((nq, B, Hkv, G * bq), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    for qi, k0, k1 in runs:  # the log-sum-exp of every query row
        s = scores(qi, k0, k1)
        m_new = torch.maximum(m[qi], s.amax(-1))
        l[qi] = l[qi] * torch.exp(m[qi] - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m[qi] = m_new
    lse = m + torch.log(l.clamp(min=1e-30))
    del m, l, s

    dq = torch.zeros_like(qb)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for qi, k0, k1 in runs:
        keys = slice(k0 * bk, k1 * bk)
        p = torch.exp(scores(qi, k0, k1) - lse[qi][..., None])
        dv[:, :, keys] += p.transpose(-1, -2) @ dob[qi]
        ds = p * (dob[qi] @ vf[:, :, keys].transpose(-1, -2) - di[qi][..., None]) * scale
        del p
        dq[qi] += ds @ kf[:, :, keys]
        dk[:, :, keys] += ds.transpose(-1, -2) @ qb[qi]
    dq = dq.reshape(nq, B, Hkv, G, bq, D).permute(1, 2, 3, 0, 4, 5).reshape(B, Hq, Sq, D)
    return dq.to(q.dtype), dk[:, :, :Skv].to(k.dtype), dv[:, :, :Skv].to(v.dtype)


@torch.library.custom_op("repro_torch::chunked_attention_backward", mutates_args=())
def chunked_attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                                  do: torch.Tensor, causal: bool, scale: float, block_q: int,
                                  block_k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`chunked_attention_bwd` as an op (plain PyTorch on every device),
    so that a DTensor call runs it on each rank's shard (batch, heads)."""
    dq, dk, dv = chunked_attention_bwd(q, k, v, out, do, causal=causal, scale=scale, block_q=block_q,
                                       block_k=block_k)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@chunked_attention_backward_op.register_fake
def _chunked_attention_backward_fake(q, k, v, out, do, causal, scale, block_q, block_k):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)  # contiguous, as the op's are


def _attention_backward_sharding(q, k, v, out, do, causal, scale, block_q, block_k):
    from torch.distributed.tensor import Replicate, Shard

    return [([p] * 3, [p] * 5 + [None] * 4) for p in (Replicate(), Shard(0), Shard(1))]


def _register_sharding() -> None:
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.chunked_attention_backward.default)(_attention_backward_sharding)


_register_sharding()


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q: int, block_k: int):
        out = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.cfg = dict(causal=causal, scale=scale, block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        # a span, so that a profile can tell this pass's kernels apart
        with instrument.span("chunked_attention_backward", q.device):
            c = ctx.cfg
            dq, dk, dv = chunked_attention_backward_op(q, k, v, out, do.contiguous(), c["causal"], c["scale"],
                                                       c["block_q"], c["block_k"])
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      scale: Optional[float] = None, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Attention with a flash-style backward.  q [B, Hq, Sq, D], k and v
    [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's type.

    The forward is the attention kernel (``flash_attention``: the CUDA kernel
    on the card, its plain version on the CPU), which masks a ragged Skv
    itself.  The backward (:func:`chunked_attention_bwd`) saves only q, k, v
    and the output, and recomputes score blocks over the reference's static
    block-pair list, K/V padded and masked where Skv has no usable divisor."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _ChunkedAttention.apply(q, k, v, causal, scale, block_q, block_k)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              use_flash: bool = False) -> torch.Tensor:
    """[B, S, H, D] tensors through :func:`chunked_attention`.  ``use_flash``
    is kept for the reference's signature: in this package both values run the
    kernel forward (the reference's other path, a flash-shaped jnp program,
    exists for its XLA dry-run, which has no counterpart here)."""
    del use_flash
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if is_dtensor(q):
        k, v = _kv_heads_for(q, k), _kv_heads_for(q, v)
    o = chunked_attention(q, k, v, causal=causal)
    return o.transpose(1, 2)


def _kv_heads_for(q, kv):
    """DTensor K or V [B, Hkv, S, D] for a DTensor q [B, Hq, S, D] whose heads
    are split over mesh dims where the KV heads are not (kv_heads below the
    degree, replicated as the specs leave them): each KV head repeated
    ``lcm(Hkv, n) / Hkv`` times and split as q is, so that each rank's
    query heads find, locally, the KV heads they read."""
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    split = [i for i, p in enumerate(q.placements) if p == Shard(1)]
    n = math.prod(mesh.size(i) for i in split)
    Hq, Hkv = q.shape[1], kv.shape[1]
    if all(kv.placements[i] == Shard(1) for i in split):
        return kv
    want = math.lcm(Hkv, n)
    if Hq % want:
        raise ValueError(f"attention: {Hq} query heads over {n} shards cannot read {Hkv} KV heads locally")
    f = want // Hkv
    if f > 1:
        B, _, S, D = kv.shape
        kv = reshape(kv[:, :, None].expand(B, Hkv, f, S, D), B, Hkv * f, S, D)
    pl = list(kv.placements)
    for i in split:
        pl[i] = Shard(1)
    return kv.redistribute(mesh, pl)
