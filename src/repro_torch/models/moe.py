"""Mixture-of-Experts layer: capacity-based token dispatch on one device.

Tokens are scattered into an ``[E, C, d]`` buffer at (expert id, position in
expert) and gathered back; an assignment whose position reaches the capacity
``C`` is dropped.  There is no ``[tokens, experts, capacity]`` one-hot
dispatch tensor.  The position of each assignment is the exclusive count of
earlier assignments to the same expert over the token-major, slot-minor
flattening of ``[T, top_k]``, which decides which tokens overflow; it comes
from the reference's hierarchical cumsum (:func:`distributed_cumsum`), kept
so that both packages count in the same order.

Routing is float32; the gates of a token's top-k experts are renormalised.
Aux losses: the switch-style load-balance loss and the router z-loss.

:func:`moe_ffn` is the reference's single-device branch and
:func:`moe_ffn_expert_parallel` its expert-parallel one, which the model
takes on a mesh with a ``model`` axis.  In :func:`moe_ffn` the scatter
and the gather run without a host sync: dropped assignments are written to,
and read from, one extra row past the buffer (the gather reads zeros there).
The expert products are batched matrix products on the card's library, as
the reference computes them outside any kernel of its own.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import mlp_act
from repro_torch.models.sharding import axis_names, mesh_axes


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped_frac: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float, multiple: int = 128) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))
    return max(_round_up(c, multiple), multiple)


def distributed_cumsum(x: torch.Tensor, blocks: int) -> torch.Tensor:
    """Exclusive cumsum over axis 0 of [A, E], in ``blocks`` chunks: an
    inclusive cumsum inside each chunk plus the exclusive sum of the chunks
    before it."""
    A, E = x.shape
    assert A % blocks == 0, (A, blocks)
    xb = x.reshape(blocks, A // blocks, E)
    inner = torch.cumsum(xb, 1)  # inclusive, within a chunk
    block_tot = inner[:, -1, :]  # [blocks, E]
    block_off = torch.cumsum(block_tot, 0) - block_tot  # exclusive over chunks
    return (inner - xb + block_off[:, None, :]).reshape(A, E)


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """float32 router logits [T, E], probabilities, and the top-k gates
    (renormalised) and expert ids [T, k]."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, -1)
    gate_vals, eids = torch.topk(probs, top_k, -1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, eids


def _experts(buf: torch.Tensor, w_gate, w_up, w_down, mlp_kind: str) -> torch.Tensor:
    """The experts' MLP on [E, C, d] in the buffer's dtype (swiglu, else gelu)."""
    g = torch.einsum("ecd,edf->ecf", buf, w_gate.to(buf.dtype))
    if mlp_kind == "swiglu":
        h = mlp_act(g, torch.einsum("ecd,edf->ecf", buf, w_up.to(buf.dtype)), "swiglu")
    else:
        h = mlp_act(g, None, "gelu")
    return torch.einsum("ecf,efd->ecd", h, w_down.to(buf.dtype))


def moe_ffn(
    x: torch.Tensor,  # [T, d] tokens (flattened batch*seq)
    router_w: torch.Tensor,  # [d, E]
    w_gate: torch.Tensor,  # [E, d, f]
    w_up: torch.Tensor,  # [E, d, f]
    w_down: torch.Tensor,  # [E, f, d]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    mlp_kind: str = "swiglu",
    cumsum_blocks: int = 32,
) -> MoEOut:
    T, d = x.shape
    E = router_w.shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)

    # ---- routing (fp32) and the aux losses ----------------------------------
    logits, probs, gate_vals, eids = _route(x, router_w, top_k)
    me = probs.mean(0)  # [E] mean router probability
    ce = F.one_hot(eids, E).float().sum(1).mean(0)  # [E] share of tokens routed (top-k hits)
    aux = E * torch.sum(me * ce) / top_k
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)

    # ---- positions within expert --------------------------------------------
    A = T * top_k
    flat_e = eids.reshape(A)
    onehot = F.one_hot(flat_e, E).float()  # [A, E]
    pos = distributed_cumsum(onehot, math.gcd(cumsum_blocks, A))  # exclusive counts
    pos = (pos * onehot).sum(-1).to(torch.int64)  # [A] position in expert
    dropped = pos >= C

    # ---- dispatch: scatter into [E, C, d]; overflow goes to a trash row -----
    slot = torch.where(dropped, E * C, flat_e * C + pos)  # row of the flat [E*C + 1, d] buffer
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat = torch.zeros(E * C + 1, d, dtype=x.dtype, device=x.device)
    flat[slot] = x[tok_idx]
    out = _experts(flat[:E * C].view(E, C, d), w_gate, w_up, w_down, mlp_kind)

    # ---- combine: gather back (a dropped assignment reads 0) and weight -----
    out = torch.cat([out.reshape(E * C, d), out.new_zeros(1, d)])
    y_rep = out[slot]  # [A, d]
    y = (y_rep * gate_vals.reshape(A, 1).to(y_rep.dtype)).reshape(T, top_k, d).sum(1)
    return MoEOut(y=y, aux_loss=aux, z_loss=z, dropped_frac=dropped.float().mean())


def moe_ffn_expert_parallel(
    x: torch.Tensor,  # [T, d] tokens, a DTensor: tokens over the data axes, d over "model"
    router_w: torch.Tensor,  # [d, E]
    w_gate: torch.Tensor,  # [E, d, f]
    w_up: torch.Tensor,  # [E, d, f]
    w_down: torch.Tensor,  # [E, f, d]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    mlp_kind: str = "swiglu",
    mesh,
    fsdp_axes: tuple = (),
    compute_dtype: torch.dtype = torch.bfloat16,
) -> MoEOut:
    """Expert-parallel MoE on a ``DeviceMesh`` with a ``model`` axis: a
    ``local_map`` body on each rank's shards, every collective explicit:

      * tokens stay on their (pod, data) shard for the whole block — routing,
        dispatch and combine are local, and the capacity is per data shard
        (GShard's semantics);
      * x's d dim is all-gathered once over ``model``;
      * the expert weights (experts over ``model``, d over the fsdp axes) are
        cast to ``compute_dtype`` and then all-gathered over the fsdp axes,
        just in time;
      * each model shard computes its E/ep experts for all its tokens; the
        combine is one all-reduce over ``model``.

    Autograd through the body turns each gather into a reduce-scatter of the
    gradient: every input's gradient leaves the body as a partial sum over
    the axes it was gathered or replicated over.  The aux losses are averaged
    over the data shards: each rank returns its shard's value over the
    number of ranks (a power of two on the meshes used, so the sum is
    exact), a partial sum whose gradient reaches every rank's routing once."""
    names, sizes = axis_names(mesh), mesh_axes(mesh)
    data_axes = [a for a in ("pod", "data") if a in names]
    ep = sizes["model"]
    T, d = x.shape
    E = router_w.shape[1]
    assert E % ep == 0, (E, ep)
    T_loc = T // math.prod(sizes[a] for a in data_axes)
    C = moe_capacity(T_loc, E, top_k, capacity_factor, multiple=4)
    e_loc = E // ep
    j = mesh.get_local_rank("model")
    ranks = math.prod(sizes.values())

    def body(x_loc, rw, wg, wu, wd):
        logits, probs, gate_vals, eids = _route(x_loc, rw, top_k)
        me = probs.mean(0)
        ce = F.one_hot(eids, E).float().sum(1).mean(0)
        aux = E * torch.sum(me * ce) / top_k
        z = torch.mean(torch.logsumexp(logits, -1) ** 2)

        # local positions within each expert (exclusive cumsum of one-hot)
        A = T_loc * top_k
        flat_e = eids.reshape(A)
        onehot = F.one_hot(flat_e, E).float()
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).to(torch.int64)
        dropped = pos >= C
        # this shard's experts only; the others' assignments, and overflow,
        # go to one trash row past the [e_loc * C] buffer
        local_e = flat_e - j * e_loc
        mine = (local_e >= 0) & (local_e < e_loc) & ~dropped
        slot = torch.where(mine, local_e * C + pos, e_loc * C)
        tok_idx = torch.arange(T_loc, device=x_loc.device).repeat_interleave(top_k)
        xd = x_loc.to(compute_dtype)
        flat = torch.zeros(e_loc * C + 1, d, dtype=compute_dtype, device=x_loc.device)
        flat[slot] = xd[tok_idx]
        out = _experts(flat[:e_loc * C].view(e_loc, C, d), wg, wu, wd, mlp_kind)
        out = torch.cat([out.reshape(e_loc * C, d), out.new_zeros(1, d)])
        # combine one top-k slot at a time ([T_loc, d] each)
        gv, sl = gate_vals.reshape(T_loc, top_k), slot.reshape(T_loc, top_k)
        y = torch.zeros(T_loc, d, dtype=compute_dtype, device=x_loc.device)
        for s in range(top_k):
            y = y + out[sl[:, s]] * gv[:, s:s + 1].to(compute_dtype)
        return y, aux / ranks, z / ranks, dropped.float().mean() / ranks

    def placements(data, model, other=Replicate()):
        return tuple(data if a in data_axes else (model if a == "model" else other) for a in names)

    def dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                                    run_check=False)

    tokens = placements(Shard(0), Replicate())
    rep = placements(Replicate(), Replicate())
    experts = placements(Replicate(), Shard(0))
    partial = placements(Partial(), Partial())
    expert_grads = placements(Partial(), Shard(0))
    fn = local_map(body, out_placements=(placements(Shard(0), Partial()), partial, partial, partial),
                   in_placements=(tokens, rep, experts, experts, experts),
                   in_grad_placements=(placements(Shard(0), Partial()), partial, expert_grads, expert_grads,
                                       expert_grads),
                   device_mesh=mesh, redistribute_inputs=True)
    wg, wu, wd = (dt(w).to(compute_dtype) for w in (w_gate, w_up, w_down))
    y, aux, z, dfrac = fn(dt(x), dt(router_w), wg, wu, wd)
    y = y.redistribute(mesh, tokens)  # the combine: one all-reduce over "model"
    aux, z, dfrac = (t.redistribute(mesh, rep) for t in (aux, z, dfrac))
    return MoEOut(y=y.to(x.dtype), aux_loss=aux, z_loss=z, dropped_frac=dfrac)


def moe_ffn_dense_ref(x, router_w, w_gate, w_up, w_down, *, top_k, mlp_kind="swiglu"):
    """No-capacity oracle: every token sees its full top-k experts (tests)."""
    T = x.shape[0]
    E = router_w.shape[1]
    _, _, gate_vals, eids = _route(x, router_w, top_k)

    def expert(e, xt):
        g = xt @ w_gate[e].to(xt.dtype)
        if mlp_kind == "swiglu":
            h = mlp_act(g, xt @ w_up[e].to(xt.dtype), "swiglu")
        else:
            h = mlp_act(g, None, "gelu")
        return h @ w_down[e].to(xt.dtype)

    all_out = torch.stack([expert(e, x) for e in range(E)])  # [E, T, d]
    y = torch.zeros_like(x)
    rows = torch.arange(T, device=x.device)
    for s in range(top_k):
        y = y + all_out[eids[:, s], rows] * gate_vals[:, s:s + 1].to(x.dtype)
    return y
