"""Port conformance: population Pareto DSE (popsim), the member axis of
DSim's multi-objective layer and DOpt's per-member Adam, and
derive_tech_targets.

The reference package vmaps one member's step; the port runs every member on
an explicit member axis.  The random draws (jitter noise, Dirichlet mixes,
hypervolume samples) are made by the reference from its keys and handed to
the port, so both packages descend the same population.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dhdl as jdhdl
import repro.core.dopt as jdopt
import repro.core.dsim as jdsim
import repro.core.graph as jgraph
import repro.core.params as jparams
import repro.core.popsim as jpop
import repro.workloads as jwl
import repro_torch.core.dhdl as tdhdl
import repro_torch.core.dopt as tdopt
import repro_torch.core.dsim as tdsim
import repro_torch.core.graph as tgraph
import repro_torch.core.params as tparams
import repro_torch.core.popsim as tpop
import repro_torch.workloads as twl
from repro_torch.core.params import from_reference
from tools.make_torch_pareto_ref import noise_of, reference_draws

CPU = "cpu"
INF = float("inf")


def _stacks(names):
    return (tgraph.Graph.stack([twl.get_workload(n, device=CPU) for n in names]),
            jgraph.Graph.stack([jwl.get_workload(n) for n in names]))


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, err_msg=what)


def _trees_close(port, ref, rtol):
    for f in dataclasses.fields(ref):
        _close(getattr(port, f.name).detach().cpu().numpy(), np.asarray(getattr(ref, f.name)), rtol, f.name)


def _member(tree, i):
    return tree.map(lambda x: x[i])


def _jittered(n: int, seed: int, sigma: float = 0.2):
    """n log-normal-jittered copies of the default design, the same in both
    packages: the reference's ``init_population`` and the port's with its draws."""
    key = jax.random.PRNGKey(seed)
    ref = jpop.init_population(key, n, sigma)
    leaves, _ = jax.tree.flatten((jparams.TechParams.default(), jparams.ArchParams.default()))
    keys = iter(jax.random.split(key, len(leaves)))
    noise = tuple({f.name: np.asarray(jax.random.normal(next(keys), (n,) + np.shape(getattr(t, f.name))))
                   for f in dataclasses.fields(t)}
                  for t in (jparams.TechParams.default(), jparams.ArchParams.default()))
    return tpop.init_population(seed, n, sigma, noise=noise, device=CPU), ref


def _onehot(metric: str, n: int) -> np.ndarray:
    w = np.zeros((n, 4), np.float32)
    w[:, tdsim.PARETO_METRICS.index(metric)] = 1.0
    return w


# --------------------------------------------------------------------------- #
# seeding and mixes
# --------------------------------------------------------------------------- #


class TestSeeding:
    def test_seed_population_with_the_references_noise(self):
        seeds = ("base", "edge", "datacenter")
        draws = reference_draws(3, 7, seeds)
        (jt, ja), jspec, jnames = jpop.seed_population(7, seeds, jax.random.split(jax.random.PRNGKey(3))[0])
        (tt, ta), tspec, tnames = tpop.seed_population(7, seeds, noise=noise_of(draws), device=CPU)
        assert tnames == jnames and tspec == from_reference(jspec)
        _trees_close(tt, jt, 1e-6)
        _trees_close(ta, ja, 1e-6)
        for i, nm in enumerate(seeds):  # the pristine members are the library designs, bit for bit
            ca = tdhdl.load_arch(nm, CPU)
            for got, want in zip(_member(tt, i).leaves() + _member(ta, i).leaves(),
                                 ca.tech.leaves() + ca.arch.leaves()):
                assert torch.equal(got, want)

    def test_jittered_members_within_bounds(self):
        (tech, arch), _, _ = tpop.seed_population(16, ("base",), key=1, sigma=3.0, device=CPU)
        for tree, (lo, hi) in ((tech, tparams.TechParams.bounds(CPU)), (arch, tparams.ArchParams.bounds(CPU))):
            for x, l, h in zip(tree.leaves(), lo.leaves(), hi.leaves()):
                assert bool(torch.all(x >= l * (1 - 1e-6))) and bool(torch.all(x <= h * (1 + 1e-6)))

    def test_same_key_same_population_other_key_other(self):
        a = tpop.seed_population(6, ("base", "edge"), key=4, device=CPU)[0][0].flatten()
        assert torch.equal(a, tpop.seed_population(6, ("base", "edge"), key=4, device=CPU)[0][0].flatten())
        assert not torch.equal(a, tpop.seed_population(6, ("base", "edge"), key=5, device=CPU)[0][0].flatten())

    def test_spec_mismatch_and_small_population_raise(self):
        with pytest.raises(ValueError, match="ArchSpec"):
            tpop.seed_population(4, ("base", "rram_cim"), device=CPU)
        with pytest.raises(ValueError, match="smaller than seed list"):
            tpop.seed_population(1, ("base", "edge"), device=CPU)

    @pytest.mark.parametrize("n,metrics", [(10, ("time", "energy", "area")), (2, ("time", "energy", "area")),
                                           (9, ("energy", "edp"))])
    def test_mixes_with_the_references_draws(self, n, metrics):
        key = jax.random.PRNGKey(11)
        want = np.asarray(jpop.sample_objective_mixes(n, metrics, key))
        draws = np.asarray(jax.random.dirichlet(key, jnp.full((len(metrics),), jnp.float32(0.7)), (n,)))
        got = tpop.sample_objective_mixes(n, metrics, draws=draws, device=CPU).numpy()
        assert np.array_equal(got, want)

    def test_mixes_are_simplex_weights_with_corners(self):
        w = tpop.sample_objective_mixes(10, device=CPU).numpy()
        assert w.shape == (10, 4)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-5)
        assert np.all(w[:, 3] == 0.0)
        np.testing.assert_array_equal(w[:3, :3], np.eye(3))


# --------------------------------------------------------------------------- #
# the member axis: DSim's multi-objective layer, gradients, Adam
# --------------------------------------------------------------------------- #


class TestMemberAxis:
    def test_population_metrics_and_values_are_per_member(self):
        tg, _ = _stacks(["lstm", "merge_sort"])
        (tech, arch), _ = _jittered(3, 2)
        w = tpop.sample_objective_mixes(3, key=2, device=CPU)
        ab, pb = torch.tensor([300.0, 150.0, INF]), torch.tensor([INF, 40.0, 60.0])
        lead = lambda t: t.map(lambda x: x.unsqueeze(1))  # noqa: E731
        val, perfs = tdsim.mixed_log_objective(lead(tech), lead(arch), tg, w, ab, pb, 2.0)
        assert val.shape == (3,) and tdsim.stacked_log_metrics(perfs).shape == (3, 4)
        for i in range(3):
            v, p = tdsim.mixed_log_objective(_member(tech, i), _member(arch, i), tg, w[i], ab[i], pb[i], 2.0)
            _close(float(val[i]), float(v), 1e-6)
            _close(tdsim.stacked_log_metrics(perfs)[i].numpy(), tdsim.stacked_log_metrics(p).numpy(), 1e-6)

    def test_population_grads_match_per_member_grads(self):
        tg, jg = _stacks(["lstm"])
        (tech, arch), (jt, ja) = _jittered(3, 3)
        w = tpop.sample_objective_mixes(3, key=3, device=CPU)
        tz = tdopt.to_log(tech).map(lambda x: x.requires_grad_(True))
        az = tdopt.to_log(arch).map(lambda x: x.requires_grad_(True))
        lead = lambda t: t.map(lambda x: x.unsqueeze(1))  # noqa: E731
        val, _ = tdsim.mixed_log_objective(lead(tdopt.from_log(tz)), lead(tdopt.from_log(az)), tg, w)
        grads = torch.autograd.grad(val.sum(), tz.leaves() + az.leaves())

        def loss(tz_, az_, wi):
            return jdsim.mixed_log_objective(jdopt.from_log(tz_), jdopt.from_log(az_), jg, wi)[0]

        for i in range(3):
            tzi = _member(tdopt.to_log(tech), i).map(lambda x: x.requires_grad_(True))
            azi = _member(tdopt.to_log(arch), i).map(lambda x: x.requires_grad_(True))
            vi, _ = tdsim.mixed_log_objective(tdopt.from_log(tzi), tdopt.from_log(azi), tg, w[i])
            gi = torch.autograd.grad(vi, tzi.leaves() + azi.leaves())
            for g, want in zip(grads, gi):
                _close(g[i].numpy(), want.numpy(), 1e-6)
            # and against the reference's value_and_grad of the same member
            jv, jgr = jax.value_and_grad(loss, argnums=(0, 1))(
                jdopt.to_log(jax.tree.map(lambda x: x[i], jt)), jdopt.to_log(jax.tree.map(lambda x: x[i], ja)),
                jnp.asarray(w[i].numpy()))
            _close(float(val[i].detach()), float(jv), 1e-5)
            for g, want in zip(grads, jax.tree.leaves(jgr)):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(want), rtol=2e-4, atol=1e-7)

    @pytest.mark.parametrize("P", [3, 4])
    def test_adam_bias_correction_by_member(self, P):
        # a [P] step against [P, N] leaves, P = N_MEM (3) or N_COMP (4): each
        # member's moments are corrected by its own step, never by a column's
        tech = tparams.TechParams.default(CPU).map(lambda x: torch.stack([x] * P))
        g = tech.map(lambda x: torch.linspace(0.5, 1.5, x.numel()).reshape(x.shape))
        st = tpop.init_population_state(tech, tparams.ArchParams.default(CPU).map(lambda x: torch.stack([x] * P)))[2]
        st = tdopt.AdamState(m=st.m, v=st.v, step=torch.arange(P, dtype=torch.int32))
        upd, new = tdopt.adam_update(g, st, 0.1)
        for i in range(P):
            one = tdopt.AdamState(m=_member(st.m, i), v=_member(st.v, i), step=st.step[i])
            want, _ = tdopt.adam_update(_member(g, i), one, 0.1)
            for a, b in zip(_member(upd, i).leaves(), want.leaves()):
                assert torch.equal(a, b)
        assert new.step.tolist() == list(range(1, P + 1))


# --------------------------------------------------------------------------- #
# the population chunk
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def chunk_pair():
    """The reference's population_chunk and the port's on the same 4 seeded
    starts (two library archs + jitter), mixes and budgets, 5 epochs."""
    seeds, P = ("base", "edge"), 4
    k_seed, k_mix = jax.random.split(jax.random.PRNGKey(0))
    (jt, ja), spec, _ = jpop.seed_population(P, seeds, k_seed)
    jw = jpop.sample_objective_mixes(P, key=k_mix)
    mixes = (jw, jnp.full((P,), 300.0), jnp.full((P,), 80.0))
    sched = jnp.linspace(0.5, 2.0, 5)
    js, jm = jpop.population_chunk(jpop.init_population_state(jt, ja), mixes, _stacks(["lstm", "merge_sort"])[1],
                                   0.1, sched, spec=spec)
    tt, ta = from_reference((jt, ja), CPU)
    tmixes = tuple(np.asarray(x) for x in mixes)
    ts, tm = tpop.population_chunk(tpop.init_population_state(tt, ta), tmixes, _stacks(["lstm", "merge_sort"])[0],
                                   0.1, np.asarray(sched), spec=from_reference(spec))
    return dict(ref=(js, np.asarray(jm)), port=(ts, tm), starts=(tt, ta), mixes=tmixes, spec=from_reference(spec),
                sched=np.asarray(sched))


class TestPopulationChunk:
    def test_history_matches_reference(self, chunk_pair):
        (_, jm), (_, tm) = chunk_pair["ref"], chunk_pair["port"]
        assert tm.shape == (5, 4, 5) and tm.dtype == np.float32
        _close(tm, jm, 1e-4)

    def test_final_state_matches_reference(self, chunk_pair):
        (js, _), (ts, _) = chunk_pair["ref"], chunk_pair["port"]
        _trees_close(ts[0], js[0], 1e-4)
        _trees_close(ts[1], js[1], 1e-4)
        assert ts[2].step.tolist() == np.asarray(js[2].step).tolist() == [5] * 4

    @pytest.mark.parametrize("metric", ["edp", "time"])
    def test_matches_sequential_optimize(self, metric):
        tg, _ = _stacks(["lstm", "merge_sort"])
        gl = [twl.get_workload(n, device=CPU) for n in ("lstm", "merge_sort")]
        (tech, arch), _ = _jittered(2, 7)
        mixes = (_onehot(metric, 2), np.full(2, INF), np.full(2, INF))
        st, m = tpop.population_chunk(tpop.init_population_state(tech, arch), mixes, tg, 0.05, np.ones(4))
        for i in range(2):
            res = tdopt.optimize(gl, tech=_member(tech, i), arch=_member(arch, i), objective=metric, steps=4, lr=0.05,
                                 fused=True, device=CPU)
            _close(m[:, i, 0], res.history["objective"], 1e-5)
            final = _member(tdopt.from_log(st[0]), i).leaves() + _member(tdopt.from_log(st[1]), i).leaves()
            for got, want in zip(final, res.tech.leaves() + res.arch.leaves()):
                _close(got.numpy(), want.numpy(), 1e-5)

    def test_matches_sequential_mixed_optimize(self):
        tg, _ = _stacks(["lstm"])
        w = np.asarray([[0.5, 0.3, 0.2, 0.0]], np.float32)
        one = [t.map(lambda x: x[None]) for t in (tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))]
        _, m = tpop.population_chunk(tpop.init_population_state(*one), (w, [300.0], [INF]), tg, 0.08,
                                     np.full(3, 2.0))
        res = tdopt.optimize([twl.get_workload("lstm", device=CPU)], objective="mixed", objective_weights=w[0],
                             area_budget=300.0, penalty_weight=2.0, steps=3, lr=0.08, fused=True, device=CPU)
        _close(m[:, 0, 0], res.history["objective"], 1e-5)

    @pytest.mark.parametrize("P", [3, 4])
    def test_diverging_member_freezes_and_leaves_the_others_unchanged(self, chunk_pair, P):
        # P = 3 (N_MEM) and 4 (N_COMP): a frozen member's step lags the others',
        # so per-member bias correction is exercised where a broadcast against
        # the last axis would go unnoticed in shape
        tt, ta = (t.map(lambda x: x[:P]) for t in chunk_pair["starts"])
        mixes = tuple(np.asarray(x)[:P] for x in chunk_pair["mixes"])
        tg, _ = _stacks(["lstm", "merge_sort"])
        kw = dict(spec=chunk_pair["spec"])
        clean_s, clean_m = tpop.population_chunk(tpop.init_population_state(tt, ta), mixes, tg, 0.1,
                                                 chunk_pair["sched"], **kw)
        poisoned = dataclasses.replace(tt, cell_area=tt.cell_area.clone())
        poisoned.cell_area[1, 2] = INF
        s, m = tpop.population_chunk(tpop.init_population_state(poisoned, ta), mixes, tg, 0.1, chunk_pair["sched"],
                                     **kw)
        others = [i for i in range(P) if i != 1]
        assert np.array_equal(m[:, others], clean_m[:, others])
        for got, want in zip(tpop._state_leaves(s), tpop._state_leaves(clean_s)):
            assert torch.equal(got[others], want[others])
        assert not np.isfinite(m[:, 1, 0]).any()  # its loss is not finite at any epoch ...
        assert s[2].step[1] == 0 and s[3].step[1] == 0  # ... so no update was ever kept
        start = tpop.init_population_state(poisoned, ta)
        for got, want in zip(tpop._state_leaves(s), tpop._state_leaves(start)):
            assert torch.equal(got[1], want[1])

    def test_unsupported_opt_over_raises(self):
        tg, _ = _stacks(["lstm"])
        one = [t.map(lambda x: x[None]) for t in (tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))]
        with pytest.raises(ValueError, match="opt_over"):
            tpop.population_chunk(tpop.init_population_state(*one), (_onehot("edp", 1), [INF], [INF]), tg, 0.1,
                                  np.ones(1), opt_over="both+types")

    @pytest.mark.parametrize("opt_over", ["tech", "arch"])
    def test_opt_over_moves_only_its_tree(self, chunk_pair, opt_over):
        tt, ta = chunk_pair["starts"]
        tg, _ = _stacks(["lstm", "merge_sort"])
        s, _ = tpop.population_chunk(tpop.init_population_state(tt, ta), chunk_pair["mixes"], tg, 0.1, np.ones(2),
                                     spec=chunk_pair["spec"], opt_over=opt_over)
        still = s[1] if opt_over == "tech" else s[0]
        start = tdopt.to_log(ta if opt_over == "tech" else tt)
        assert all(torch.equal(a, b) for a, b in zip(still.leaves(), start.leaves()))

    def test_population_log_metrics_match_reference(self, chunk_pair):
        (js, _), (ts, _) = chunk_pair["ref"], chunk_pair["port"]
        _, jg = _stacks(["lstm", "merge_sort"])
        tg, _ = _stacks(["lstm", "merge_sort"])
        want = jpop.population_log_metrics(jdopt.from_log(js[0]), jdopt.from_log(js[1]), jg,
                                           jparams.ArchSpec(**dataclasses.asdict(chunk_pair["spec"])))
        got = tpop.population_log_metrics(tdopt.from_log(ts[0]), tdopt.from_log(ts[1]), tg, chunk_pair["spec"])
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), 1e-4)


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #

DSE_KW = dict(seeds=("base", "edge"), population=8, steps=6, lr=0.1, area_budget=400.0, power_budget=80.0)


@pytest.fixture(scope="module")
def dse_pair():
    """tests/test_popsim.py's pareto_dse, in both packages, with the
    reference's draws handed to the port."""
    ref = jpop.pareto_dse([jwl.get_workload("lstm")], key=0, **DSE_KW)
    draws = reference_draws(0, DSE_KW["population"], DSE_KW["seeds"])
    port = tpop.pareto_dse([twl.get_workload("lstm", device=CPU)], noise=noise_of(draws),
                           mix_draws=draws["mix_draws"], hv_samples=draws["hv_samples"], device=CPU, **DSE_KW)
    return port, ref


class TestParetoDse:
    def test_matches_reference(self, dse_pair):
        port, ref = dse_pair
        assert port.seeds == ref.seeds and port.spec == from_reference(ref.spec)
        np.testing.assert_array_equal(port.weights, ref.weights)
        _close(port.history, ref.history, 1e-4)
        _close(port.log_metrics, ref.log_metrics, 1e-4)
        _close(port.area, ref.area, 1e-4)
        _close(port.power, ref.power, 1e-4)
        np.testing.assert_array_equal(port.feasible, ref.feasible)
        np.testing.assert_array_equal(port.front, ref.front)
        _close(port.hypervolume, ref.hypervolume, 1e-4)
        _close(port.hv_lo, ref.hv_lo, 1e-4)
        _close(port.hv_ref, ref.hv_ref, 1e-4)
        assert [w["index"] for w in port.winners] == [w["index"] for w in ref.winners]

    def test_front_is_feasible_and_non_dominated(self, dse_pair):
        port, _ = dse_pair
        from repro_torch.core.pareto import dominates

        assert port.front.size >= 1 and port.feasible[port.front].all()
        sub = torch.tensor(port.front_log_metrics)
        assert not dominates(sub[:, None], sub[None, :]).any()
        assert port.history.shape == (6, 8, 5) and np.isfinite(port.history).all()

    def test_winners_round_trip_bit_exact(self, dse_pair):
        port, ref = dse_pair
        assert port.winners
        for w in port.winners:
            i = w["index"]
            ca = tdhdl.parse_arch(w["dhd"], device=CPU)
            assert ca.spec == port.spec
            for got, want in zip(ca.tech.leaves() + ca.arch.leaves(),
                                 _member(port.tech, i).leaves() + _member(port.arch, i).leaves()):
                assert torch.equal(got, want)
            assert tdhdl.serialize_arch(ca) == w["dhd"]
            # the reference parses the port's text to the same design
            jca = jdhdl.parse_arch(w["dhd"])
            for got, want in zip(ca.tech.leaves() + ca.arch.leaves(), jax.tree.leaves((jca.tech, jca.arch))):
                assert np.array_equal(got.numpy(), np.asarray(want))

    def test_chunked_run_matches_single_chunk(self):
        kw = dict(seeds=("base",), population=4, steps=4, lr=0.1, area_budget=400.0, key=3, device=CPU)
        a = tpop.pareto_dse([twl.get_workload("lstm", device=CPU)], chunk=None, **kw)
        b = tpop.pareto_dse([twl.get_workload("lstm", device=CPU)], chunk=2, **kw)
        np.testing.assert_array_equal(a.history, b.history)
        np.testing.assert_array_equal(a.log_metrics, b.log_metrics)

    def test_bench_configuration_matches_the_fixture(self):
        # benchmarks/bench_pareto.py's full run on the CPU, held as chip_smoke.py
        # holds it on the card (tests/data/torch_pareto_ref.npz)
        import chip_smoke

        ref = dict(np.load(chip_smoke.PARETO_FIXTURE))
        out = chip_smoke.hold_pareto(chip_smoke.fixture_pareto_dse(ref, CPU), ref)
        assert out["front_equal"] and out["history"] <= chip_smoke.PARETO_RTOL


# --------------------------------------------------------------------------- #
# legacy helpers and derive_tech_targets
# --------------------------------------------------------------------------- #


class TestLegacy:
    def test_population_objective_matches_reference(self):
        tg, jg = _stacks(["lstm", "merge_sort"])
        (tech, arch), (jt, ja) = _jittered(3, 5)
        for obj in ("edp", "energy"):
            _close(tpop.population_objective((tech, arch), tg, obj).numpy(),
                   np.asarray(jpop.population_objective((jt, ja), jg, obj)), 1e-5)

    def test_dse_step_matches_reference(self):
        tg, jg = _stacks(["lstm"])
        (tech, arch), (jt, ja) = _jittered(2, 6)
        new, val = tpop.make_dse_step(lr=0.05)((tech, arch), tg)
        jnew, jval = jpop.make_dse_step(lr=0.05)((jt, ja), jg)
        _close(val.numpy(), np.asarray(jval), 1e-5)
        _trees_close(new[0], jnew[0], 1e-5)
        _trees_close(new[1], jnew[1], 1e-5)


@pytest.mark.parametrize("names,objective", [(["lstm"], "edp"), (["lstm", "merge_sort"], "energy")])
def test_derive_tech_targets_matches_reference(names, objective):
    got = tdopt.derive_tech_targets([twl.get_workload(n, device=CPU) for n in names], goal_factor=1e9,
                                    objective=objective, steps=5, device=CPU)
    want = jdopt.derive_tech_targets([jwl.get_workload(n) for n in names], goal_factor=1e9, objective=objective,
                                     steps=5)
    assert got["epochs"] == want["epochs"] == 5
    assert list(got["targets"]) == list(want["targets"])
    for k, t in want["targets"].items():
        _close([got["targets"][k][f] for f in ("start", "target", "factor")], [t[f] for f in ("start", "target",
                                                                                          "factor")], 1e-4, k)
    _close(got["achieved_factor"], want["achieved_factor"], 1e-4)
    _close(got["baseline_objective"], want["baseline_objective"], 1e-5)
    _close(got["history"]["edp"], want["history"]["edp"], 1e-4)
