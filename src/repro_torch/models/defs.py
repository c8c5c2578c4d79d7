"""Parameter definitions: one declarative tree per model.

A model's parameters are a nested dict of :class:`ParamDef` leaves (shape,
logical axis names, initializer).  From that one tree come

  * :func:`param_count` — the parameter count, with no tensor made;
  * :func:`init_params` — tensors drawn on a device from an explicit
    ``torch.Generator``;
  * :func:`init_numpy` — numpy arrays from ``np.random.default_rng(seed)``, so
    that this package and the JAX reference can be fed identical weights.

Both initializers visit the leaves in one fixed order, the sorted order of
the dict keys at every level (the order in which JAX flattens a dict), and
make one draw for each leaf whose init is random.

Init kinds: ``normal`` (std ``scale / sqrt(fan_in)``, fan_in the second-last
dim), ``embed`` (std ``scale``), ``zeros``, ``ones``, ``ssm_a`` (Mamba's A_log,
``log(1..n)`` tiled over the leading dims) and ``dt_bias`` (the inverse
softplus of dt log-spaced over [1e-3, 1e-1]).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis name per dim
    init: str = "normal"
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def leaves(defs, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], ParamDef]]:
    """(path, ParamDef) of every leaf, keys sorted at every level."""
    if is_def(defs):
        yield path, defs
        return
    for k in sorted(defs):
        yield from leaves(defs[k], path + (k,))


def map_defs(fn, defs):
    """The tree of ``fn(leaf)`` over every ParamDef, in :func:`leaves` order."""
    if is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(defs))


def _std(d: ParamDef) -> float:
    fan_in = 1 if d.init == "embed" else (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
    return d.scale / math.sqrt(max(fan_in, 1))


def _fixed(d: ParamDef) -> Optional[np.ndarray]:
    """The float32 value of a leaf whose init draws nothing, else None."""
    if d.init == "zeros":
        return np.zeros(d.shape, np.float32)
    if d.init == "ones":
        return np.ones(d.shape, np.float32)
    if d.init == "ssm_a":
        n = d.shape[-1]
        row = np.log(np.arange(1, n + 1, dtype=np.float32))
        return np.ascontiguousarray(np.broadcast_to(row, d.shape))
    if d.init == "dt_bias":
        u = np.linspace(math.log(1e-3), math.log(1e-1), num=math.prod(d.shape), dtype=np.float32)
        dt = np.exp(u).reshape(d.shape)
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    if d.init in ("normal", "embed"):
        return None
    raise ValueError(f"unknown init kind {d.init!r}")


def init_numpy(defs, seed: int) -> dict:
    """Numpy float32 arrays for every leaf: one ``standard_normal`` draw per
    random leaf from ``np.random.default_rng(seed)``, in :func:`leaves` order."""
    rng = np.random.default_rng(seed)

    def one(d: ParamDef) -> np.ndarray:
        fixed = _fixed(d)
        if fixed is not None:
            return fixed
        x = rng.standard_normal(d.shape, dtype=np.float32)
        x *= np.float32(_std(d))
        return x

    return map_defs(one, defs)


def init_params(defs, generator: torch.Generator, device: torch.device) -> dict:
    """Tensors for every leaf, drawn on ``device`` from ``generator`` (which
    must live on that device), each in its ParamDef's dtype."""

    def one(d: ParamDef) -> torch.Tensor:
        fixed = _fixed(d)
        if fixed is not None:
            return torch.from_numpy(fixed).to(device=device, dtype=d.dtype)
        t = torch.empty(d.shape, dtype=torch.float32, device=device)
        t.normal_(0.0, _std(d), generator=generator)  # in place: no second full-size copy
        return t if d.dtype == torch.float32 else t.to(d.dtype)

    return map_defs(one, defs)
