"""Sharding-spec trees for every program of the dry run and the mesh paths
(train / prefill / decode), and their DTensor placements.

Everything is derived from the ParamDef trees — one source of truth — so the
specs always match the structure of the (meta or real) inputs.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import defs as D
from repro_torch.models.model import Model
from repro_torch.models.sharding import NamedPlacements, Spec, axis_names, batch_spec, distribute, is_spec, \
    logical_to_spec, repair_spec
from repro_torch.optim.adamw import AdamWConfig, Q8, q8_scale_shape
from repro_torch.train.train_step import TrainConfig


def moment_specs(model: Model, mesh, opt_cfg: AdamWConfig, fsdp_axes):
    """Spec tree for one Adam moment (m or v), mirroring the param specs.
    Q8 leaves get (codes=param_spec, scale=param_spec[:-1] + (None,))."""
    ax = axis_names(mesh)

    def one(d: D.ParamDef):
        spec = repair_spec(logical_to_spec(d.axes, ax, fsdp_axes), d.shape, mesh)
        if not opt_cfg.int8_states:
            return spec
        entries = list(spec) + [None] * (len(d.shape) - len(spec))
        sshape = q8_scale_shape(d.shape)
        scale_spec = repair_spec(Spec(*entries[:-1], None), sshape, mesh) if len(d.shape) else Spec(None)
        return Q8(codes=spec, scale=scale_spec)

    return D.map_defs(one, model.param_defs())


def train_state_specs(model: Model, mesh, opt_cfg: AdamWConfig, tcfg: TrainConfig):
    fsdp = model.fsdp_axes()
    pspecs = model.specs(mesh, fsdp)
    mom = moment_specs(model, mesh, opt_cfg, fsdp)
    out = {
        "params": pspecs,
        "opt": {"m": mom, "v": mom, "step": Spec()},
        "step": Spec(),
    }
    if tcfg.compress_grads:
        out["ef_err"] = pspecs
    return out


def batch_specs(cfg: ModelConfig, mesh, batch_abs: dict | None = None) -> dict:
    tok_dims = 2 if cfg.audio else 1  # [B, S(, ncb)]
    out = {
        "tokens": batch_spec(mesh, tok_dims),
        "labels": batch_spec(mesh, tok_dims),
    }
    if cfg.vision:
        out["vision"] = batch_spec(mesh, 2)
    if batch_abs is not None:  # repaired against the batch's shapes (the keys it has)
        out = {k: repair_spec(out[k], tuple(batch_abs[k].shape), mesh) for k in out if k in batch_abs}
    return out


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig, seq: int | None = None, batch: int | None = None) -> dict:
    """The batch as meta tensors (token ids int64, as ``data.batch_to`` makes them)."""
    B = batch or shape.global_batch
    S = seq or shape.seq_len
    tshape = (B, S, cfg.audio.n_codebooks) if cfg.audio else (B, S)
    out = {
        "tokens": torch.empty(tshape, dtype=torch.int64, device="meta"),
        "labels": torch.empty(tshape, dtype=torch.int64, device="meta"),
    }
    if cfg.vision:
        out["vision"] = torch.empty((B, cfg.vision.n_patches, cfg.vision.d_vision), dtype=torch.float32,
                                    device="meta")
    return out


def as_placements(mesh, spec_tree):
    """The tree of :class:`NamedPlacements` (a spec on ``mesh``, with its
    DTensor placements) of a spec tree: what ``Checkpointer.restore``'s
    ``shardings`` takes."""
    return tu.tree_map(lambda s: NamedPlacements(mesh, s), spec_tree, is_leaf=is_spec)


def distribute_tree(tree, mesh, spec_tree):
    """A tree of tensors (real or meta) laid out by a spec tree of the same
    structure: each leaf a DTensor holding its shard (``sharding.distribute``)."""
    return tu.tree_map(lambda s, x: distribute(x, mesh, s), spec_tree, tree, is_leaf=is_spec)
