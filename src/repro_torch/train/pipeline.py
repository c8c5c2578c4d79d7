"""GPipe pipeline parallelism over a ``DeviceMesh`` dim of stages.

Each stage holds its share of a stack of homogeneous layers ([L, ...]
params split over the stage dim, L/S layers resident a stage: no weight
moves) and only activations cross stage boundaries.  The microbatches enter
replicated; the schedule runs S + M - 1 ticks: at tick t stage 0 takes
microbatch t, every other stage the activation the previous stage sent after
tick t - 1, and the last stage emits microbatch t - (S - 1) from tick S - 1
on; at the end the last stage's outputs go to every rank.

The backward is autograd through the schedule (1F1B-equivalent traffic
without a hand-written backward schedule): each point-to-point hop is an
``autograd.Function`` whose backward is the reverse hop, and the final
broadcast's backward takes a replicated output's gradient once, from the
last stage.  A stage computes only on ticks where it holds a microbatch, and
a hop carries only an activation the next stage uses (no bubble compute and
nothing sent through the ring's wrap to stage 0): the same outputs and
gradients as computing the bubbles on clipped inputs and masking them.  Every
rank runs the backward, in tick order: a zero-size token threads each rank's
hops, so that each hop's backward runs after the later ticks' and pairs with
its peer's.  With one stage every hop is the identity and nothing is sent.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import tree as tu


def _p2p(send: torch.Tensor | None, dst: int | None, recv: torch.Tensor | None, src: int | None, group) -> None:
    """Send ``send`` to global rank ``dst`` and receive ``recv`` from ``src``
    (either may be None) as one batch, and wait for both."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


class _Hop(torch.autograd.Function):
    """One tick's hop on one rank: send ``h`` (or nothing) to the next stage
    and receive the previous stage's activation (or nothing, when ``prev`` is
    None), in a tensor like ``like``.  Backward: the reverse hop."""

    @staticmethod
    def forward(ctx, h, tok, like, group, prev, nxt):
        got = torch.empty_like(like) if prev is not None else None
        _p2p(h, nxt, got, prev, group)
        ctx.sent, ctx.group, ctx.prev, ctx.nxt, ctx.like = h is not None, group, prev, nxt, like
        return got, (None if tok is None else tok.view_as(tok))

    @staticmethod
    def backward(ctx, g_got, g_tok):
        g_h = torch.empty_like(ctx.like) if ctx.sent else None
        _p2p(g_got if ctx.prev is not None else None, ctx.prev, g_h, ctx.nxt, ctx.group)
        return g_h, g_tok, None, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs broadcast to every stage.  Backward: every
    rank holds the replicated output's whole gradient; the last stage takes
    it once, the others none."""

    @staticmethod
    def forward(ctx, outs, tok, group, src, is_src):
        y = outs.clone() if is_src else outs
        dist.broadcast(y, src, group=group)
        ctx.is_src = is_src
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else None), g.new_zeros(0), None, None, None


def gpipe(
    layer_fn: Callable,  # (layer_params, x) -> x
    n_stages: int,
    n_microbatches: int,
    stage_axis: str = "stage",
):
    """Build a pipelined apply: ``apply(params_local, x, mesh) -> outs``.

    It runs on each rank's own tensors (inside :func:`pipeline_apply`'s
    ``local_map``): ``params_local`` is a tree of this stage's [L/S, ...]
    layer params, ``x`` the [M, mb, ...] microbatches, whole on every rank,
    ``mesh`` the ``DeviceMesh`` whose ``stage_axis`` dim holds the
    ``n_stages`` stages.  A layer keeps its input's shape and dtype.  Returns
    the [M, mb, ...] outputs, equal on every rank of the stage dim.
    ``n_microbatches`` is kept for the reference's signature: M is
    ``x.shape[0]``."""
    del n_microbatches
    S = n_stages

    def run_stage(params_local, h):
        for i in range(tu.leaves(params_local)[0].shape[0]):
            h = layer_fn(tu.tree_map(lambda p: p[i], params_local), h)
        return h

    def apply(params_local, x, mesh):
        M = x.shape[0]
        stage = mesh.get_local_rank(stage_axis)
        group = mesh.get_group(stage_axis)
        peer = lambda s: dist.get_global_rank(group, s)  # noqa: E731
        like = x[0]
        tok = None
        if S > 1 and torch.is_grad_enabled():
            # threads this rank's hops in tick order for the backward; through x, so that x
            # has a gradient (zeros past stage 0) on every rank
            tok = torch.zeros(0, device=x.device, requires_grad=True)
            if x.requires_grad:
                tok = tok + x.reshape(-1)[:0]
        outs, buf = [None] * M, None
        for t in range(S + M - 1):
            mine = 0 <= t - stage < M  # this stage holds microbatch t - stage
            h = None
            if mine:
                h = run_stage(params_local, x[t] if stage == 0 else buf)
                if stage == S - 1:
                    outs[t - stage] = h
            send = mine and stage < S - 1
            recv = stage > 0 and 0 <= t - (stage - 1) < M  # the previous stage sends at tick t
            if send or recv:
                buf, tok = _Hop.apply(h if send else None, tok, like, group, peer(stage - 1) if recv else None,
                                      peer(stage + 1) if send else None)
        if S == 1:
            return torch.stack(outs)
        y = torch.stack(outs) if stage == S - 1 else x.new_empty(x.shape)
        return _FromLast.apply(y, tok, group, peer(S - 1), stage == S - 1)

    return apply


def pipeline_apply(
    mesh,
    layer_fn: Callable,
    stacked_params,  # [L, ...] tree
    x,  # [B, ...] activations
    *,
    n_microbatches: int,
    stage_axis: str = "stage",
):
    """GPipe over the ``stage_axis`` dim of ``mesh``: the stacked params
    split over the stages (``Shard(0)``), the batch's ``n_microbatches``
    microbatches replicated, :func:`gpipe`'s schedule in a ``local_map``.
    Returns ``y`` [B, ...], equal on every rank.

    Each leaf of ``stacked_params`` and ``x`` is a plain tensor, whole on
    every rank, or a DTensor on ``mesh``; ``y`` is a DTensor when ``x`` is
    one, else a plain tensor.  Gradients: a stacked parameter's come from the
    stage that holds its rows (a plain leaf gets its whole gradient on every
    rank), ``x``'s from stage 0 alone (reduced over the stages)."""
    n_stages = mesh.size(tuple(mesh.mesh_dim_names).index(stage_axis))
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} is not a multiple of {n_microbatches} microbatches")
    leaves = tu.leaves(stacked_params)
    if leaves[0].shape[0] % n_stages:
        raise ValueError(f"{leaves[0].shape[0]} stacked layers do not split over {n_stages} stages")
    dim = tuple(mesh.mesh_dim_names).index(stage_axis)
    split = n_stages > 1
    rep = (Replicate(),) * mesh.ndim
    layers = tuple(Shard(0) if d == dim and split else Replicate() for d in range(mesh.ndim))
    x_grad = tuple(Partial() if d == dim and split else Replicate() for d in range(mesh.ndim))

    def dt(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t if tuple(t.placements) == placements else t.redistribute(mesh, placements)

    xm = x.reshape((n_microbatches, B // n_microbatches) + tuple(x.shape[1:]))
    apply = gpipe(layer_fn, n_stages, n_microbatches, stage_axis)

    def body(xl, *pl):
        return apply(tu.unflatten_like(stacked_params, list(pl)), xl, mesh)

    fn = local_map(
        body, out_placements=(rep,), in_placements=(rep,) + (layers,) * len(leaves),
        in_grad_placements=(x_grad,) + (layers,) * len(leaves), device_mesh=mesh)
    y = fn(dt(xm, rep), *(dt(p, layers) for p in leaves))
    y = y.reshape((B,) + tuple(x.shape[1:]))
    return y if isinstance(x, DTensor) else y.to_local()

