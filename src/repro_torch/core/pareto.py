"""Pareto-front extraction and the hypervolume indicator, on the device.

Multi-objective DSE (popsim.pareto_dse) needs two primitives over a
population's metric vectors, both tensor-only so they run where the
population lives:

  * :func:`non_dominated_mask` — which designs survive non-dominated
    filtering (all metrics are COSTS: smaller is better);
  * :func:`hypervolume` — the volume, w.r.t. a reference point, of the
    region dominated by a point set: the standard scalar indicator of
    front quality (bigger is better, monotone under adding non-dominated
    points).

Conventions:

* a point ``a`` dominates ``b`` iff ``all(a <= b)`` and ``any(a < b)``
  — duplicates do not dominate each other, so both survive filtering;
* hypervolume is exact for 2 objectives (staircase sweep) and a
  deterministic quasi-Monte-Carlo estimate for 3+ (fixed unit samples).
  With a shared sample box (``lo``/``samples``), the MC estimate is
  *exactly* monotone under adding points: every sample dominated by S is
  dominated by any superset of S.  Pass the same ``lo`` and samples when
  comparing fronts.

The unit samples are an explicit ``[n_samples, M]`` argument: made on the
host by ``numpy.random.default_rng(key)`` when none are given, so the same
key gives the same estimate on the CPU and on the card.

Inputs that are tensors stay on their device; anything else is placed on
``device`` (the card unless the caller names another).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

__all__ = [
    "dominates",
    "non_dominated_mask",
    "pareto_front",
    "hypervolume",
    "hv_ref_point",
    "unit_samples",
]


def _f32(x, device=None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=resolve_device(device))


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` dominates ``b`` (costs: all coords <=, at least one <).

    Broadcasts over leading axes: ``dominates(p[:, None], p[None, :])`` is
    the full [N, N] domination matrix.
    """
    return torch.all(a <= b, dim=-1) & torch.any(a < b, dim=-1)


def non_dominated_mask(points, feasible=None, device=None) -> torch.Tensor:
    """[N] bool mask of the non-dominated subset of ``points`` [N, M].

    ``feasible`` (optional [N] bool) removes constraint-violating designs
    *before* filtering: infeasible points neither enter the front nor
    shadow feasible ones.  O(N^2) pairwise — exact, and one batched
    comparison on the device.
    """
    pts = _f32(points, device)
    if feasible is not None:
        feasible = torch.as_tensor(feasible, dtype=torch.bool, device=pts.device)
        # an infeasible point must not dominate anything: move it to +inf,
        # where it can only *be* dominated
        pts = torch.where(feasible[:, None], pts, torch.full_like(pts, float("inf")))
    dom = dominates(pts[:, None, :], pts[None, :, :])  # dom[i, j]: i dominates j
    mask = ~torch.any(dom, dim=0)
    if feasible is not None:
        mask = mask & feasible
    return mask


def pareto_front(points, feasible=None, device=None) -> np.ndarray:
    """Host convenience: sorted indices of the non-dominated subset."""
    return np.nonzero(non_dominated_mask(points, feasible, device).cpu().numpy())[0]


def _hv_exact_2d(pts: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Exact 2-objective hypervolume: area of the dominated staircase.

    Points beyond ``ref`` are clipped to it — they dominate at most a
    measure-zero slice of the reference box, so clipping preserves the
    volume.  Dominated/duplicate points contribute zero height and need no
    pre-filtering.
    """
    p = torch.minimum(pts, ref)
    # by x, ties by y: a stable sort by y, then a stable sort by x
    order = torch.argsort(p[:, 1], stable=True)
    order = order[torch.argsort(p[order, 0], stable=True)]
    x, y = p[order, 0], p[order, 1]
    y_run = torch.cummin(y, 0).values  # best y seen at or left of each x
    prev = torch.cat([ref[1:], y_run[:-1]])
    return torch.sum((ref[0] - x) * torch.clamp_min(prev - y_run, 0.0))


def unit_samples(n_samples: int, m: int, key: int = 0) -> np.ndarray:
    """[n_samples, m] float32 draws in [0, 1) from ``numpy.random.default_rng(key)``."""
    return np.random.default_rng(key).random((int(n_samples), m), dtype=np.float32)


def hypervolume(
    points,
    ref,
    *,
    lo=None,
    n_samples: int = 16384,
    samples=None,
    key: int = 0,
    device=None,
) -> torch.Tensor:
    """Hypervolume of the region dominated by ``points`` [N, M] within the
    box ``[lo, ref]`` (costs; ``ref`` is the anti-ideal corner).

    * M == 2: exact (``lo``/``n_samples``/``samples``/``key`` ignored).
    * M >= 3: quasi-Monte-Carlo over fixed unit samples — deterministic,
      and with a common ``lo``/samples exactly monotone under adding points
      (the dominated-sample set can only grow).  ``samples`` [n, M] are
      unit draws in [0, 1), mapped into the box as ``max(lo, u*(ref-lo)+lo)``;
      without them, ``unit_samples(n_samples, M, key)`` are drawn.  ``lo``
      defaults to the pointwise minimum of ``points`` clipped to ``ref``;
      pass an explicit common ``lo`` when comparing the values of different
      fronts.
    """
    pts = _f32(points, device)
    pts = pts.reshape(1, -1) if pts.ndim < 2 else pts
    m = pts.shape[-1]
    ref = torch.broadcast_to(_f32(ref, pts.device).to(pts.device), (m,))
    if m == 2:
        return _hv_exact_2d(pts, ref)
    lo = torch.minimum(torch.amin(pts, 0), ref) if lo is None else _f32(lo, pts.device).to(pts.device)
    u = _f32(unit_samples(n_samples, m, key) if samples is None else samples, pts.device).to(pts.device)
    if u.ndim != 2 or u.shape[1] != m:
        raise ValueError(f"hypervolume: samples {tuple(u.shape)} are not [n, {m}]")
    s = torch.maximum(lo, u * (ref - lo) + lo)
    covered = torch.any(torch.all(pts[:, None, :] <= s[None, :, :], dim=-1), dim=0)
    box = torch.prod(torch.clamp_min(ref - lo, 0.0))
    return box * torch.mean(covered.to(torch.float32))


def hv_ref_point(points, margin: float = 0.1, device=None) -> torch.Tensor:
    """A reference (anti-ideal) point just beyond the worst of ``points``:
    per-axis max plus ``margin`` of the axis range (at least ``margin``
    absolute, so degenerate axes still leave room and boundary points
    contribute volume)."""
    pts = _f32(points, device)
    pts = pts.reshape(1, -1) if pts.ndim < 2 else pts
    hi, lo = torch.amax(pts, 0), torch.amin(pts, 0)
    return hi + torch.clamp_min(margin * (hi - lo), margin)
