"""The train step: loss -> grads -> AdamW, with microbatch gradient
accumulation and optional error-feedback int8 gradient compression.

``make_train_step`` returns a function (state, batch) -> (state, metrics)
that updates the state in place (the counterpart of the reference's donated
state).  Gradients are taken by ``torch.autograd.grad`` with respect to
detached views of the float32 master parameters, so the graph holds no
reference to the state that the optimizer then updates.

With ``mesh=`` (a ``DeviceMesh``) the state is a tree of DTensors laid out by
``launch.specs.train_state_specs`` (:func:`distribute_train_state`); each
microbatch is laid out by ``batch_specs``, the model runs on the mesh, and
each gradient is reduced to its parameter's placements before AdamW updates
every shard in place.  The metrics come back as plain tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as tu
from repro_torch.data.pipeline import batch_to
from repro_torch.models.model import Model, on_mesh
from repro_torch.models.sharding import is_dtensor
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.grad_compress import ef_compress_tree, init_error_buffer


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False


def _state(params, opt_cfg: AdamWConfig, tcfg: TrainConfig) -> dict:
    dev = tu.leaves(params)[0].device
    state = {"params": params, "opt": init_opt_state(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tcfg.compress_grads:
        state["ef_err"] = init_error_buffer(params)
    return state


def init_train_state(model: Model, seed: int = 0, opt_cfg: AdamWConfig = AdamWConfig(),
                     tcfg: TrainConfig = TrainConfig(), device=None) -> dict:
    """{"params", "opt", "step"[, "ef_err"]}: weights drawn on ``device``
    (None: the card) from ``torch.Generator(device).manual_seed(seed)``, zero
    moments, step 0."""
    return _state(model.init(seed, device), opt_cfg, tcfg)


def abstract_train_state(model: Model, opt_cfg: AdamWConfig = AdamWConfig(), tcfg: TrainConfig = TrainConfig()):
    """The train state's structure, shapes and dtypes as tensors on the
    ``meta`` device: nothing is drawn or allocated."""
    return _state(model.abstract_params(), opt_cfg, tcfg)


def distribute_train_state(state: dict, model: Model, opt_cfg: AdamWConfig, tcfg: TrainConfig, mesh) -> dict:
    """A train state (real or meta tensors) as DTensors on ``mesh``, laid out
    by ``launch.specs.train_state_specs``."""
    from repro_torch.launch.specs import distribute_tree, train_state_specs

    return distribute_tree(state, mesh, train_state_specs(model, mesh, opt_cfg, tcfg))


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model: Model, opt_cfg: AdamWConfig, tcfg: TrainConfig = TrainConfig(), mesh=None):
    """(state, batch) -> (state, metrics).  The batch (numpy arrays or
    tensors, leading dim the batch) is split into ``tcfg.microbatches``
    slices whose grads, loss and metrics are averaged; metrics are the
    loss's plus ``grad_norm``, ``lr`` and ``total_loss``, 0-d tensors on the
    device.  ``mesh``: the state is laid out on it (see the module's note)."""
    mb = tcfg.microbatches

    def grads_of(params, batch):
        live = tu.tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tu.leaves(live)
        with torch.enable_grad(), on_mesh(mesh):
            total, metrics = model.loss(live, batch, mesh=mesh)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if mesh is not None:  # partial sums and other layouts reduced to the parameter's placements
            grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g
                     for p, g in zip(leaves, grads)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def layout(sub: dict) -> dict:
        if mesh is None:
            return sub
        from repro_torch.launch.specs import batch_specs, distribute_tree

        return distribute_tree(sub, mesh, batch_specs(model.cfg, mesh, sub))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        batch = batch_to(batch, tu.leaves(params)[0].device)
        for i in range(mb):
            sub = layout({k: x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))[i] for k, x in batch.items()})
            l, m, g = grads_of(params, sub)
            if i == 0:
                loss, metrics, grads = l, m, g
            else:
                loss = loss + l
                metrics = {k: metrics[k] + m[k] for k in metrics}
                for a, b in zip(grads, g):
                    a.add_(b)
            del g
        if mb > 1:
            grads = [g.div_(mb) for g in grads]
            loss = loss / mb
            metrics = {k: v / mb for k, v in metrics.items()}
        grads = tu.unflatten_like(params, grads)
        if tcfg.compress_grads:
            grads, new_err = ef_compress_tree(grads, state["ef_err"])
            with torch.no_grad():
                for e, n in zip(tu.leaves(state["ef_err"]), tu.leaves(new_err)):
                    e.copy_(n)
        with on_mesh(mesh):
            _, _, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
            state["step"] += 1
        out = {**metrics, **opt_metrics, "total_loss": loss}
        return state, ({k: _plain(v) for k, v in out.items()} if mesh is not None else out)

    return train_step
