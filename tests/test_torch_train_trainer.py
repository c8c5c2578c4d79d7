"""The port's train step and Trainer against the reference on the CPU, and
its own fault-tolerance tests (mirroring tests/test_fault_tolerance.py).

``make_train_step`` with 1 and 2 microbatches and with error-feedback
gradient compression off and on runs 3 steps from one state in both
packages: the loss histories agree within rtol 1e-4.  The port's ``Trainer``
and the reference's restore from one step-0 checkpoint written from
``Model.init_numpy`` weights and train on the same data stream: loss
histories within rtol 1e-4.  float32 configs, so that the comparison
measures the two packages and not bf16 rounding.

The train step runs at ``AdamWConfig``'s default lr, 3e-4.  At lr 3e-3 the
compressed cases' third loss differs by rel 5.2e-4 (the uncompressed ones
stay within 1e-4): the jitted reference rounds some int8 codes the other way
from its own eager run on the same grads (181 of 16,384 embedding entries),
a flipped code moves that gradient entry by a whole code step, and Adam's
early, sign-like steps carry it into the loss.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import init_error_buffer as jax_init_err
from repro.optim import init_opt_state as jax_init_opt
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch import tree as tu
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.ft import FailureInjector, SimulatedFailure
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import AdamWConfig, init_opt_state, warmup_cosine
from repro_torch.train import (TrainConfig, Trainer, TrainerConfig, abstract_train_state, init_train_state,
                               make_train_step)

SHAPE = ShapeConfig("tiny", 64, 4, "train")
ARCH = "granite-3-8b"


def _cfgs(**kw):
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw), dataclasses.replace(port_config(ARCH).reduced(), **kw))


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False), (1, True), (2, True)])
def test_train_step_matches_reference(microbatches, compress):
    jcfg, tcfg = _cfgs(dtype="float32")
    w = build_model(tcfg).init_numpy(0)
    kw = dict(lr=3e-4)  # AdamWConfig's default
    jopt, topt = JaxAdamW(**kw), AdamWConfig(**kw)
    jt, tt = JaxTrainConfig(microbatches, compress), TrainConfig(microbatches, compress)
    jparams = jax.tree.map(jnp.asarray, w)
    jstate = {"params": jparams, "opt": jax_init_opt(jparams, jopt), "step": jnp.int32(0)}
    if compress:
        jstate["ef_err"] = jax_init_err(jparams)
    tparams = params_from_numpy(tcfg, w, "cpu")
    tstate = {"params": tparams, "opt": init_opt_state(tparams, topt), "step": torch.zeros((), dtype=torch.int32)}
    if compress:
        tstate["ef_err"] = tu.tree_map(torch.zeros_like, tparams)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg), jopt, jt))
    tstep = make_train_step(build_model(tcfg), topt, tt)
    jl, tl = [], []
    for s in range(3):
        batch = make_batch(tcfg, SHAPE, s, batch_override=4, seq_override=32)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        jl.append(float(jm["total_loss"]))
        tl.append(float(tm["total_loss"]))
        assert set(tm) == set(jm) == {"loss", "moe_aux", "moe_z", "tokens", "grad_norm", "lr", "total_loss"}
        if s == 0 and not compress:  # later norms follow Adam's first, sign-like update of near-zero grads;
            # an int8 code that rounds the other way moves a compressed grad by a whole code step
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["tokens"]) == float(jm["tokens"]) == 4 * 32 / microbatches
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tstate["step"]) == int(tstate["opt"]["step"]) == 3


def test_train_step_leaves_the_numpy_weights_alone():
    """``params_from_numpy`` copies: a train step updates params in place,
    and must not write through to the arrays they came from (the reference
    may be reading them)."""
    _, tcfg = _cfgs(dtype="float32")
    w = build_model(tcfg).init_numpy(0)
    before = [np.array(x, copy=True) for x in jax.tree.leaves(w)]
    params = params_from_numpy(tcfg, w, "cpu")
    opt = AdamWConfig()
    state = {"params": params, "opt": init_opt_state(params, opt), "step": torch.zeros((), dtype=torch.int32)}
    make_train_step(build_model(tcfg), opt)(state, make_batch(tcfg, SHAPE, 0, batch_override=4, seq_override=32))
    assert any(not np.array_equal(b, p.numpy()) for b, p in zip(before, tu.leaves(params)))
    for a, b in zip(jax.tree.leaves(w), before):
        np.testing.assert_array_equal(a, b)


def test_abstract_state_is_meta_and_matches_init():
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    for opt in (AdamWConfig(), AdamWConfig(int8_states=True)):
        tc = TrainConfig(compress_grads=True)
        like = abstract_train_state(model, opt, tc)
        real = init_train_state(model, 0, opt, tc, device="cpu")
        lp, rp = list(tu.leaves_with_path(like)), list(tu.leaves_with_path(real))
        assert [p for p, _ in lp] == [p for p, _ in rp]
        for (p, a), (_, b) in zip(lp, rp):
            assert a.device.type == "meta" and a.shape == b.shape and a.dtype == b.dtype, p


def test_init_train_state_draws_from_the_seed():
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    a, b, c = (init_train_state(model, s, device="cpu")["params"]["layers"]["wq"] for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------------------------------- #
# the Trainer against the reference's, from one checkpoint
# --------------------------------------------------------------------------- #


def test_trainer_matches_reference_from_one_checkpoint(tmp_path):
    jcfg, tcfg = _cfgs(dtype="float32")
    w = build_model(tcfg).init_numpy(0)
    params = params_from_numpy(tcfg, w, "cpu")
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(2, 8))
    state = {"params": params, "opt": init_opt_state(params, opt), "step": torch.zeros((), dtype=torch.int32)}
    Checkpointer(str(tmp_path / "port"), async_save=False).save(0, state, extra={"data_step": 0})
    shutil.copytree(tmp_path / "port", tmp_path / "ref")

    from repro.optim import warmup_cosine as jax_warmup_cosine

    rcfg = dict(steps=8, ckpt_every=4, log_every=0)
    ref = JaxTrainer(jax_build(jcfg), JaxShape("tiny", 64, 4, "train"), JaxAdamW(lr=1e-3, schedule=jax_warmup_cosine(2, 8)),
                     JaxTrainConfig(), JaxTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **rcfg), log_fn=lambda s: None)
    out_ref = ref.run()
    port = Trainer(build_model(tcfg), SHAPE, opt, TrainConfig(), TrainerConfig(ckpt_dir=str(tmp_path / "port"), **rcfg),
                   log_fn=lambda s: None, device="cpu")
    out = port.run()
    assert len(out["losses"]) == len(out_ref["losses"]) == 8
    np.testing.assert_allclose(out["losses"], out_ref["losses"], rtol=1e-4)
    assert [h["step"] for h in port.history] == list(range(8))
    # the reference's last checkpoint restores in the port, and resumes there
    like = abstract_train_state(build_model(tcfg), opt)
    from_ref, extra = Checkpointer(str(tmp_path / "ref")).restore(None, like, device="cpu")
    assert extra == {"data_step": 8} and int(from_ref["step"]) == int(from_ref["opt"]["step"]) == 8
    assert all(bool(torch.isfinite(x.float()).all()) for x in tu.leaves(from_ref))


# --------------------------------------------------------------------------- #
# fault tolerance (tests/test_fault_tolerance.py, on the port)
# --------------------------------------------------------------------------- #


def make_trainer(tmp_path, steps=12, injector=None):
    _, tcfg = _cfgs()
    return Trainer(build_model(tcfg), SHAPE, AdamWConfig(lr=1e-3, schedule=None), TrainConfig(),
                   TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp_path), log_every=0),
                   injector=injector, log_fn=lambda s: None, device="cpu")


class TestCrashRecovery:
    def test_restart_resumes_and_finishes(self, tmp_path):
        logs = []
        tr = make_trainer(tmp_path, injector=FailureInjector(fail_at=(6,)))
        tr.log = logs.append
        out = tr.run()
        assert int(out["state"]["step"]) == 12
        assert out["losses"][-1] < out["losses"][0]
        assert any("restored checkpoint at step 4" in s for s in logs), logs
        assert [h["step"] for h in tr.history] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 10, 11]

    def test_too_many_failures_raise(self, tmp_path):
        class AlwaysFail(FailureInjector):
            def maybe_fail(self, step):
                if step == 5:
                    raise SimulatedFailure("persistent failure")

        tr = make_trainer(tmp_path, injector=AlwaysFail())
        with pytest.raises(SimulatedFailure):
            tr.run()
        assert sum(h["step"] == 4 for h in tr.history) == tr.rcfg.max_restarts + 1

    def test_resume_replays_identical_stream(self, tmp_path):
        """Run A: uninterrupted. Run B: crash at step 6, restore from step 4.
        Both must end with identical parameters (deterministic data + ckpt)."""
        out_a = make_trainer(tmp_path / "a", steps=10).run()
        out_b = make_trainer(tmp_path / "b", steps=10, injector=FailureInjector(fail_at=(6,))).run()
        for (p, x), (_, y) in zip(tu.leaves_with_path(out_a["state"]["params"]),
                                  tu.leaves_with_path(out_b["state"]["params"])):
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), atol=1e-6, err_msg=p)


def test_injected_slow_steps_detected_in_training(tmp_path):
    out = make_trainer(tmp_path, steps=14, injector=FailureInjector(slow_at=(10,), slow_secs=3.0)).run()
    assert any(s == 10 for s, _ in out["stragglers"]), out["stragglers"]
