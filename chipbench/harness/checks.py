"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out from the same inputs.

Descent (a DOpt population, the training rule): over the first three epochs,
which set-up drives through the window's own call,

  * ``loss_gap``: each epoch's population loss (the members' mean objective
    value) against the reference's, as a share of the mean magnitude of the
    reference's values; the worst epoch;
  * ``grad_gap``: the first gradient, as the optimizer holds it after one
    epoch (Adam's first moment over 1 - beta1), by parameter leaf: the gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf; the worst leaf;
  * ``change_gap``: the same of each leaf's change in log space after the
    three epochs, over the leaves whose first gradient in the reference is at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone).

Sweep (answers checked one by one): for every design of the sampled
requests, its four log metrics and the logs of its worst-case area and power
against the reference's; ``answer_gap`` is the widest gap, and
``share_off`` the share of designs off by more than ``OFF``.
"""
from __future__ import annotations

import numpy as np
import torch

B1 = 0.9
OFF = 1e-5


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """|norm(prog leaf) - norm(ref leaf)| over max(norm(ref leaf), median ref
    norm), for each leaf (or each in ``keep``)."""
    norms = {k: _norm(ref[k]) for k in ref}
    med = float(np.median(list(norms.values())))
    keys = [k for k in ref if keep is None or k in keep]
    return {k: abs(_norm(prog[k]) - norms[k]) / max(norms[k], med, 1e-300) for k in keys}


def moving_leaves(grad_ref: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: _norm(g) for k, g in grad_ref.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def descent_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``rows`` [3, P, 5] (numpy), ``grad`` (the
    first gradient, one dict of leaves) and ``change`` (z after three epochs
    minus z before, one dict of leaves)."""
    loss = 0.0
    member = []
    for e in range(ref["rows"].shape[0]):
        vp, vr = prog["rows"][e, :, 0].astype(np.float64), ref["rows"][e, :, 0].astype(np.float64)
        fp, fr = np.isfinite(vp), np.isfinite(vr)
        if not np.array_equal(fp, fr) or not fr.any():
            loss = float("inf")
            member.append(np.full(vr.shape, np.inf))
            continue
        loss = max(loss, abs(vp[fr].mean() - vr[fr].mean()) / max(np.abs(vr[fr]).mean(), 1e-300))
        member.append(np.where(fr, np.abs(vp - vr), 0.0))
    member = np.max(member, axis=0)
    grad = leaf_gaps(prog["grad"], ref["grad"])
    moving = moving_leaves(ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], moving)
    return dict(
        loss_gap=float(loss), grad_gap=max(grad.values()), change_gap=max(change.values()),
        member_gap_max=float(member.max()), member_gap_median=float(np.median(member)),
        worst_grad_leaf=max(grad, key=grad.get), worst_change_leaf=max(change, key=change.get),
        still_leaves=sorted(set(ref["grad"]) - moving),
    )


def sweep_gaps(prog: tuple, ref: tuple) -> np.ndarray:
    """Each design's widest gap, in log units: its four log metrics, and the
    logs of its worst-case area and power.  Non-finite where either side is."""
    (lp, ap, pp), (lr, ar, pr) = ([np.asarray(x, np.float64) for x in side] for side in (prog, ref))
    gaps = np.concatenate([np.abs(lp - lr), np.abs(np.log(ap / ar))[:, None], np.abs(np.log(pp / pr))[:, None]], 1)
    return np.where(np.isfinite(gaps).all(1), gaps.max(1), np.inf)


def sweep_numbers(gaps: np.ndarray) -> dict:
    return dict(answer_gap=float(gaps.max()), share_off=float(np.mean(gaps > OFF)),
                gap_median=float(np.median(gaps)), designs=int(gaps.size))
