"""The SSM families' training path on the CPU against the reference:
``Model.loss`` and its gradients for falcon-mamba-7b (Mamba1, K5) and
zamba2-1.2b (Mamba2, K4, and the shared attention block), a 3-step
``make_train_step`` history, and the port's own ``Trainer`` restart, at the
reduced configs with 2 layers (zamba2's ``attn_every`` is 2 there, so its one
shared block runs), float32.

The reference runs once a model, in a module-scoped fixture.  Its zamba2
runs the Mamba2 layers through the reference's per-step oracle
``repro.kernels.ref.ssd_reference`` in place of the chunked
``repro.models.mamba.ssd_scan``, whose ``jax.grad`` is NaN at these decays
(tests/test_torch_ssm_grad.py says why); the two are equal in value, and the
swap lives in the fixture.

Tolerances, as tests/test_torch_train_loss.py's: the loss within rtol 1e-5,
each leaf's gradient within 1e-4 of that leaf's norm, the train-step history
within rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jax_ref
from repro.models import ssm_models as jax_ssm
from repro.models.model import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import init_opt_state as jax_init_opt
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch import tree as tu
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.ft import FailureInjector
from repro_torch.kernels import ssd, sscan
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, Trainer, TrainerConfig, make_train_step

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
SHAPE = ShapeConfig("tiny", 48, 2, "train")  # 48 tokens: one K5 chunk, a ragged K4 chunk
STEPS = 3


def _cfgs(arch: str, **kw):
    kw = dict(dtype="float32", n_layers=2, **kw)
    return dataclasses.replace(jax_config(arch).reduced(), **kw), dataclasses.replace(port_config(arch).reduced(), **kw)


def _oracle(x, dt, A, Bm, Cm, chunk=64, state0=None):
    return jax_ref.ssd_reference(x, dt, A, Bm, Cm)


@pytest.fixture(scope="module")
def reference():
    """{arch: (weights, batches, loss, grads by path, 3-step history)} from the reference, once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ssm, "ssd_scan", _oracle)
        for arch in ARCHS:
            jcfg, tcfg = _cfgs(arch)
            w = build_model(tcfg).init_numpy(0)
            batches = [make_batch(tcfg, SHAPE, s) for s in range(STEPS)]
            jm = jax_build(jcfg)
            params = jax.tree.map(jnp.asarray, w)
            loss, grads = jax.value_and_grad(lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batches[0]))[0])(params)
            opt = JaxAdamW(lr=3e-4)
            state = {"params": params, "opt": jax_init_opt(params, opt), "step": jnp.int32(0)}
            step = jax.jit(jax_make_train_step(jm, opt, JaxTrainConfig()))
            history = []
            for b in batches:
                state, m = step(state, jax.tree.map(jnp.asarray, b))
                history.append(float(m["total_loss"]))
            out[arch] = (w, batches, float(loss), dict(tu.leaves_with_path(jax.tree.map(np.asarray, grads))), history)
    return out


def _port_loss(arch, w, batch, remat="none"):
    _, tcfg = _cfgs(arch, remat=remat)
    live = tu.tree_map(lambda p: p.requires_grad_(True), params_from_numpy(tcfg, w, "cpu"))
    total, metrics = build_model(tcfg).loss(live, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(total, tu.leaves(live))
    return float(total.detach()), metrics, dict(zip((p for p, _ in tu.leaves_with_path(live)), grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match_reference(arch, reference):
    w, batches, jloss, jgrads, _ = reference[arch]
    loss, metrics, grads = _port_loss(arch, w, batches[0])
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert float(metrics["moe_aux"]) == float(metrics["moe_z"]) == 0.0
    assert float(metrics["tokens"]) == SHAPE.global_batch * SHAPE.seq_len
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        want = jgrads[path]
        assert np.all(np.isfinite(want)), path
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= 1e-4 * max(float(np.linalg.norm(want)), 1e-12), (path, err, float(np.linalg.norm(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_each_scan_and_gives_equal_grads(arch, reference, monkeypatch):
    """"full" and "dots" run each SSM layer's scan again in the backward (its
    states op twice a layer), "none" once; the grads are equal."""
    mod, name = (sscan, "selective_scan_states_op") if arch.startswith("falcon") else (ssd, "ssd_chunk_scan_states_op")
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(1) or real(*a))
    w, batches, _, _, _ = reference[arch]
    loss0, _, g0 = _port_loss(arch, w, batches[0], "none")
    assert len(calls) == 2
    for mode in ("full", "dots"):
        calls.clear()
        loss, _, g = _port_loss(arch, w, batches[0], mode)
        assert len(calls) == 4, mode
        assert loss == loss0, mode
        for path in g0:
            np.testing.assert_allclose(g[path].numpy(), g0[path].numpy(), rtol=1e-6, atol=1e-9, err_msg=f"{mode} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_history_matches_reference(arch, reference):
    w, batches, _, _, jhistory = reference[arch]
    _, tcfg = _cfgs(arch)
    params = params_from_numpy(tcfg, w, "cpu")
    opt = AdamWConfig(lr=3e-4)
    state = {"params": params, "opt": init_opt_state(params, opt), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(build_model(tcfg), opt)
    history = [float(step(state, b)[1]["total_loss"]) for b in batches]
    np.testing.assert_allclose(history, jhistory, rtol=1e-4)
    assert all(bool(torch.isfinite(p).all()) for p in tu.leaves(state["params"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_restart_equals_an_uninterrupted_run(arch, tmp_path):
    """A failure at step 3 restores the step-2 checkpoint and ends with the
    uninterrupted run's parameters, bit for bit."""
    _, tcfg = _cfgs(arch, remat="full")
    outs = {}
    for run, injector in (("straight", None), ("restarted", FailureInjector(fail_at=(3,)))):
        logs = []
        tr = Trainer(build_model(tcfg), SHAPE, AdamWConfig(lr=1e-3), TrainConfig(),
                     TrainerConfig(steps=5, ckpt_every=2, ckpt_dir=str(tmp_path / run), log_every=0),
                     injector=injector, log_fn=logs.append, device="cpu")
        outs[run] = tr.run()
        outs[run]["steps"] = [h["step"] for h in tr.history]
    assert outs["restarted"]["steps"] == [0, 1, 2, 2, 3, 4]
    assert outs["straight"]["losses"][-1] == outs["restarted"]["losses"][-1]
    for (path, a), (_, b) in zip(tu.leaves_with_path(outs["straight"]["state"]["params"]),
                                 tu.leaves_with_path(outs["restarted"]["state"]["params"])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_training_forward_builds_no_decode_cache(arch, reference):
    """The layers under gradients return the hidden state alone; the prefill's
    forward still collects the conv windows and states, equal in hidden
    state to the training forward's."""
    w, batches, _, _, _ = reference[arch]
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg)
    params = params_from_numpy(tcfg, w, "cpu")
    tokens = torch.from_numpy(batches[0]["tokens"]).long()
    h, _, caches = model.forward(params, tokens, head=False)
    assert caches == {}
    with torch.no_grad():
        h2, _, caches = model.forward(params, tokens, head=False, collect_cache=True)
    assert set(caches) == ({"conv", "state"} if arch.startswith("falcon") else {"conv", "state", "k", "v"})
    torch.testing.assert_close(h.detach(), h2, rtol=0, atol=0)
