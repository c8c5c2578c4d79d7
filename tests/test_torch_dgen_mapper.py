"""Port conformance: DGen's specialize and the mapper (values and gradients),
plus the affine-scan kernel's plain version against the reference kernel.

Tolerances follow the reference's own tests: mapper values rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6 (tests/test_mapper_equiv.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dgen as jdgen
import repro.core.dopt as jdopt
import repro.core.dsim as jdsim
import repro.core.mapper as jmapper
import repro.core.params as jparams
import repro.workloads as jwl
import repro_torch.core.dgen as tdgen
import repro_torch.core.dopt as tdopt
import repro_torch.core.dsim as tdsim
import repro_torch.core.mapper as tmapper
import repro_torch.core.params as tparams
import repro_torch.workloads as twl
from repro.kernels.sscan import affine_scan as j_affine_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sscan as tsscan

CPU = "cpu"
WORKLOADS = ["lstm", "bert_base", "merge_sort"]
IMPLS = ["ref", "assoc", "pallas"]
# a soft memory-technology selection (rows: localMem, globalBuf, mainMem)
SOFT_TW = np.asarray(jax.nn.softmax(jnp.asarray([[1.0, 0.2, -0.5], [0.3, 0.9, 0.1], [-1.0, 0.0, 2.0]]), -1))


def _np(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _pair():
    return (jparams.TechParams.default(), jparams.ArchParams.default(),
            tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


class TestDgen:
    @pytest.mark.parametrize("soft", [False, True], ids=["one_hot", "soft_types"])
    def test_concrete_hw_fields(self, soft):
        jt, ja, tt, ta = _pair()
        jc = jdgen.specialize(jt, ja, type_weights=jnp.asarray(SOFT_TW) if soft else None)
        tc = tdgen.specialize(tt, ta, type_weights=torch.tensor(SOFT_TW) if soft else None)
        assert len(dataclasses.fields(tc)) == 16
        for name, want in _np(jc).items():
            _close(getattr(tc, name).numpy(), want, 1e-6, what=name)
        _close(tc.total_area.numpy(), np.asarray(jc.total_area), 1e-6)

    @pytest.mark.parametrize("metric", ["total_area", "frequency"])
    def test_gradients(self, metric):
        jt, ja, tt, ta = _pair()

        def jf(t, a):
            return getattr(jdgen.specialize(t, a), metric)

        jg = jax.grad(jf, argnums=(0, 1))(jt, ja)
        tt = tt.map(lambda x: x.requires_grad_(True))
        ta = ta.map(lambda x: x.requires_grad_(True))
        out = getattr(tdgen.specialize(tt, ta), metric)
        grads = torch.autograd.grad(out, tt.leaves() + ta.leaves(), allow_unused=True)
        want = [np.asarray(x) for x in jax.tree.leaves(jg[0]) + jax.tree.leaves(jg[1])]
        for g, w in zip(grads, want):
            g = np.zeros_like(w) if g is None else g.numpy()
            _close(g, w, 1e-5, atol=1e-6 * max(np.abs(w).max(), 1e-30))

    def test_population_specialize_matches_vmap(self):
        scales = np.linspace(0.5, 2.0, 5, dtype=np.float32)
        jt, ja, tt, ta = _pair()
        jc = jax.vmap(lambda s: jdgen.specialize(
            dataclasses.replace(jt, cell_read_latency=jt.cell_read_latency * s), ja))(jnp.asarray(scales))
        tt.cell_read_latency = tt.cell_read_latency * torch.tensor(scales)[:, None]
        tc = tdgen.specialize(tt, ta)
        for name, want in _np(jc).items():
            # fields that do not depend on the scaled latency stay unbatched
            got = np.broadcast_to(getattr(tc, name).numpy(), want.shape)
            _close(got, want, 1e-6, what=name)


@pytest.fixture(scope="module")
def mapper_pairs():
    """(port MapState, reference MapState) per (workload, impl)."""
    jt, ja, tt, ta = _pair()
    jc, tc = jdgen.specialize(jt, ja), tdgen.specialize(tt, ta)
    out = {}
    for n in WORKLOADS:
        jg, tg = jwl.get_workload(n), twl.get_workload(n, device=CPU)
        for impl in IMPLS:
            out[n, impl] = (tmapper.map_workload(tc, tg, tmapper.MapperCfg(scan_impl=impl)),
                            jmapper.map_workload(jc, jg, jmapper.MapperCfg(scan_impl=impl)))
    return out


@pytest.fixture(scope="module")
def grad_pairs():
    """d log(edp) / d to_log(tech) for the port and the reference, per (workload, impl)."""
    out = {}
    for n in WORKLOADS:
        jg, tg = jwl.get_workload(n), twl.get_workload(n, device=CPU)
        for impl in ("ref", "assoc"):
            def jloss(tz):
                return jnp.log(jdsim.simulate(jdopt.from_log(tz), jparams.ArchParams.default(), jg,
                                              mcfg=jmapper.MapperCfg(scan_impl=impl)).edp)

            jgr = jax.grad(jloss)(jdopt.to_log(jparams.TechParams.default()))
            tz = tdopt.to_log(tparams.TechParams.default(CPU)).map(lambda x: x.requires_grad_(True))
            loss = torch.log(tdsim.simulate(tdopt.from_log(tz), tparams.ArchParams.default(CPU), tg,
                                            mcfg=tmapper.MapperCfg(scan_impl=impl)).edp)
            tgr = torch.autograd.grad(loss, tz.leaves())
            out[n, impl] = ([g.numpy() for g in tgr], [np.asarray(g) for g in jax.tree.leaves(jgr)])
    return out


class TestMapper:
    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("name", WORKLOADS)
    def test_map_state_matches_reference(self, mapper_pairs, name, impl):
        got, want = mapper_pairs[name, impl]
        for f in dataclasses.fields(want):
            _close(getattr(got, f.name).detach().numpy(), np.asarray(getattr(want, f.name)), 1e-5,
                   atol=1e-30, what=f"{name}/{impl}/{f.name}")

    @pytest.mark.parametrize("impl", ["ref", "assoc"])
    @pytest.mark.parametrize("name", WORKLOADS)
    def test_tech_gradients_match_reference(self, grad_pairs, name, impl):
        got, want = grad_pairs[name, impl]
        for g, w in zip(got, want):
            _close(g, w, 1e-4, atol=1e-6)

    def test_stacked_mapper_equals_per_workload(self):
        tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        gs = [twl.get_workload(n, device=CPU) for n in WORKLOADS]
        from repro_torch.core.graph import Graph

        stacked = tmapper.map_workload(tc, Graph.stack(gs), tmapper.MapperCfg(scan_impl="assoc"))
        for w, g in enumerate(gs):
            one = tmapper.map_workload(tc, g, tmapper.MapperCfg(scan_impl="assoc"))
            for f in dataclasses.fields(one):
                _close(getattr(stacked, f.name)[w].numpy(), getattr(one, f.name).numpy(), 1e-6, atol=1e-30)

    def test_breakdown_sums_to_cycles(self):
        tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        g = twl.get_workload("bert_base", device=CPU).pad_to(128)
        bd = tmapper.map_workload_breakdown(tc, g)
        ms = tmapper.map_workload(tc, g)
        _close(float(bd["cycles_v"].sum()), float(ms.cycles), 1e-6)
        assert float(bd["cycles_v"][109:].abs().sum()) == 0.0

    def test_minaffine_prefix_matches_python(self):
        x = torch.tensor(np.random.default_rng(1).uniform(0, 3, 131), dtype=torch.float32)
        out = tmapper.minaffine_prefix_assoc(0.5, x, torch.tensor(2.5)).numpy()
        s, expect = 0.0, []
        for v in x.numpy():
            s = min(0.5 * s + v, 2.5)
            expect.append(s)
        _close(out, expect, 1e-5)

    def test_unknown_scan_impl_raises(self):
        tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        with pytest.raises(ValueError):
            tmapper.map_workload(tc, twl.get_workload("lstm", device=CPU), tmapper.MapperCfg(scan_impl="x"))


class TestAffineScanPlain:
    @pytest.mark.parametrize("V", [1, 33, 707])
    def test_values_and_gradients_match_reference_kernel(self, V):
        rng = np.random.default_rng(V)
        x = rng.uniform(0, 0.4, V).astype(np.float32)
        cot = rng.uniform(0, 1, V).astype(np.float32)
        want = np.asarray(j_affine_scan(0.8, jnp.asarray(x)))
        want_g = np.asarray(jax.grad(lambda v: jnp.sum(j_affine_scan(0.8, v) * cot))(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        got = tsscan.affine_scan(0.8, xt)
        (got * torch.tensor(cot)).sum().backward()
        _close(got.detach().numpy(), want, 1e-5)
        _close(xt.grad.numpy(), want_g, 1e-4, atol=1e-6)

    def test_batched_rows_and_reverse(self):
        x = torch.tensor(np.random.default_rng(3).uniform(0, 1, (4, 70)), dtype=torch.float32)
        fwd = tref.affine_scan_reference(0.8, x)
        rev = tref.affine_scan_reference(0.8, x, reverse=True)
        for r in range(4):
            s, expect = 0.0, []
            for v in x[r].numpy():
                s = 0.8 * s + v
                expect.append(s)
            _close(fwd[r].numpy(), expect, 1e-5)
            _close(rev[r].numpy(), tref.affine_scan_reference(0.8, x[r].flip(0)).flip(0).numpy(), 0)
