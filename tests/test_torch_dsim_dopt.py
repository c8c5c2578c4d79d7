"""Port conformance: DSim's batched estimates and objectives, and DOpt's
optimize() (fused and per-step, with the NaN rollback) against the reference.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dopt as jdopt
import repro.core.dsim as jdsim
import repro.core.graph as jgraph
import repro.core.params as jparams
import repro.workloads as jwl
import repro_torch.core.dopt as tdopt
import repro_torch.core.dsim as tdsim
import repro_torch.core.graph as tgraph
import repro_torch.core.params as tparams
import repro_torch.workloads as twl

CPU = "cpu"
STACK = ["lstm", "dlrm", "merge_sort"]
OPT_SET = ["lstm", "merge_sort"]
HIST_KEYS = ("objective", "runtime", "energy", "area", "edp", "fault")


def _np(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _stacks(names):
    return (jgraph.Graph.stack([jwl.get_workload(n) for n in names]),
            tgraph.Graph.stack([twl.get_workload(n, device=CPU) for n in names]))


def _defaults():
    return (jparams.TechParams.default(), jparams.ArchParams.default(),
            tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))


class TestDsim:
    def test_simulate_stacked_matches_reference(self):
        jg, tg = _stacks(STACK)
        jt, ja, tt, ta = _defaults()
        want = jdsim.simulate_stacked(jt, ja, jg)
        got = tdsim.simulate_stacked(tt, ta, tg)
        for f in dataclasses.fields(want):
            if f.name == "state":
                for g in dataclasses.fields(want.state):
                    _close(getattr(got.state, g.name).numpy(), np.asarray(getattr(want.state, g.name)), 1e-5,
                           atol=1e-30, what=g.name)
            else:
                _close(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)), 1e-5, what=f.name)

    def test_objectives_match_reference(self):
        jg, tg = _stacks(STACK)
        jt, ja, tt, ta = _defaults()
        for obj, ac in [("edp", None), ("time", 50.0), ("energy", None), ("power", None)]:
            jv, _ = jdsim.stacked_log_objective(jt, ja, jg, obj, ac)
            tv, _ = tdsim.stacked_log_objective(tt, ta, tg, obj, ac)
            _close(float(tv), float(jv), 1e-5, what=obj)
        w = np.asarray([0.3, 0.2, 0.1, 0.4], np.float32)
        jv, jp = jdsim.mixed_log_objective(jt, ja, jg, jnp.asarray(w), 100.0, 5.0, 2.0)
        tv, tp = tdsim.mixed_log_objective(tt, ta, tg, torch.tensor(w), 100.0, 5.0, 2.0)
        _close(float(tv), float(jv), 1e-5)
        _close(tdsim.stacked_log_metrics(tp).numpy(), np.asarray(jdsim.stacked_log_metrics(jp)), 1e-5)

    def test_inf_budget_gives_zero_penalty_and_finite_gradient(self):
        _, tg = _stacks(STACK)
        tt, ta = tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU)
        tz = tdopt.to_log(tt).map(lambda x: x.requires_grad_(True))
        onehot = torch.tensor([0.0, 0.0, 0.0, 1.0])
        val, perfs = tdsim.mixed_log_objective(tdopt.from_log(tz), ta, tg, onehot, float("inf"), float("inf"))
        pen = tdsim.budget_penalty(perfs, float("inf"), float("inf"))
        assert float(pen.detach()) == 0.0
        ref_val, _ = tdsim.stacked_log_objective(tdopt.from_log(tz), ta, tg, "edp")
        assert float(val.detach()) == float(ref_val.detach())
        grads = torch.autograd.grad(val, tz.leaves())
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        gp = torch.autograd.grad(tdsim.budget_penalty(tdsim.simulate_stacked(tdopt.from_log(tz), ta, tg),
                                                      float("inf"), float("inf")), tz.leaves())
        assert all(float(g.abs().max()) == 0.0 for g in gp)

    def test_simulate_breakdown_matches_reference(self):
        jt, ja, tt, ta = _defaults()
        jp, jx = jdsim.simulate_breakdown(jt, ja, jwl.get_workload("bert_base").pad_to(128))
        tp, tx = tdsim.simulate_breakdown(tt, ta, twl.get_workload("bert_base", device=CPU).pad_to(128))
        _close(float(tp.cycles), float(jp.cycles), 1e-5)
        for k, v in jx.items():
            _close(tx[k].detach().numpy(), np.asarray(v), 1e-5, atol=1e-30, what=k)


def _run_pair(names, **kw):
    jg = [jwl.get_workload(n) for n in names]
    tg = [twl.get_workload(n, device=CPU) for n in names]
    return tdopt.optimize(tg, device=CPU, **kw), jdopt.optimize(jg, **kw)


@pytest.fixture(scope="module")
def opt_runs():
    return {
        "fused": _run_pair(OPT_SET, steps=6, fused=True),
        "per_step": _run_pair(OPT_SET, steps=6, fused=False),
        "nan_epoch": _run_pair(OPT_SET, steps=6, nan_epochs=(2,)),
        "dopt2_mixed": _run_pair(OPT_SET, steps=3, opt_over="both+types", objective="mixed",
                                 objective_weights=[0.5, 0.2, 0.1, 0.2], area_budget=200.0),
    }


class TestDopt:
    @pytest.mark.parametrize("run", ["fused", "per_step", "nan_epoch", "dopt2_mixed"])
    def test_history_and_params_match_reference(self, opt_runs, run):
        got, want = opt_runs[run]
        for k in HIST_KEYS:
            _close(got.history[k], want.history[k], 1e-4, what=k)
        for t, j in ((got.tech, want.tech), (got.arch, want.arch)):
            for name, arr in _np(j).items():
                _close(getattr(t, name).numpy(), arr, 1e-4, what=name)
        if want.type_weights is not None:
            _close(got.type_weights.numpy(), np.asarray(want.type_weights), 1e-4)
        g_imp, w_imp = dict(got.importance), dict(want.importance)
        assert set(g_imp) == set(w_imp) == set(tdopt.tech_param_names())
        for k, v in w_imp.items():
            _close(g_imp[k], v, 1e-3, atol=1e-6, what=k)

    def test_nan_epoch_rolls_back(self, opt_runs):
        got, _ = opt_runs["nan_epoch"]
        assert got.history["fault"] == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
        assert got.history["objective"][2] == got.history["objective"][1]
        assert all(np.isfinite(got.history["objective"]))

    def test_fused_equals_per_step(self, opt_runs):
        a, b = opt_runs["fused"][0], opt_runs["per_step"][0]
        assert a.history == b.history

    def test_default_chunk_and_names(self):
        assert tdopt._default_chunk(200, None) == jdopt._default_chunk(200, None) == 50
        assert tdopt._default_chunk(60, 2.0) == jdopt._default_chunk(60, 2.0)
        assert tdopt.tech_param_names() == jdopt.tech_param_names()

    def test_adam_update_matches_reference(self):
        rng = np.random.default_rng(0)
        p = rng.normal(size=5).astype(np.float32)
        gs = [rng.normal(size=5).astype(np.float32) for _ in range(3)]
        js, ts = jdopt.adam_init(jnp.asarray(p)), tdopt.adam_init(torch.tensor(p))
        for g in gs:
            ju, js = jdopt.adam_update(jnp.asarray(g), js, 0.05)
            tu, ts = tdopt.adam_update(torch.tensor(g), ts, torch.tensor(0.05))
            _close(tu.numpy(), np.asarray(ju), 1e-6)

    def test_bad_mixed_arguments_raise(self):
        g = twl.get_workload("lstm", device=CPU)
        with pytest.raises(ValueError):
            tdopt.optimize(g, objective="mixed", steps=1, device=CPU)
        with pytest.raises(ValueError):
            tdopt.optimize(g, objective="edp", area_budget=1.0, steps=1, device=CPU)
