"""Port conformance: parameter spaces, workload graphs and the LM tracer.

Construction is numpy in both packages, so every array must be bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.core.params as jparams
import repro.workloads as jwl
import repro_torch.core.graph as tgraph
import repro_torch.core.params as tparams
import repro_torch.workloads as twl

CPU = "cpu"
LM_CELLS = [("qwen2.5-32b", "prefill_32k"), ("granite-3-8b", "train_4k")]
CLASSIC = [n for fam in jwl.WORKLOAD_FAMILIES.values() for n in fam]


def _np(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _graph_np(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in tgraph.DATA_FIELDS}


def _assert_graph_equal(tg, jg):
    assert tg.names == jg.names
    for f in tgraph.DATA_FIELDS:
        a, b = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


class TestParams:
    @pytest.mark.parametrize("cls", ["TechParams", "ArchParams"])
    def test_default_and_bounds_bit_equal(self, cls):
        tc, jc = getattr(tparams, cls), getattr(jparams, cls)
        pairs = [(tc.default(CPU), jc.default())]
        pairs += list(zip(tc.bounds(CPU), jc.bounds()))
        for t, j in pairs:
            for name, arr in _np(j).items():
                got = getattr(t, name)
                assert got.dtype == torch.float32 and got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), arr, err_msg=name)

    @pytest.mark.parametrize("cls", ["TechParams", "ArchParams"])
    def test_from_numpy_round_trips(self, cls):
        tc, jc = getattr(tparams, cls), getattr(jparams, cls)
        t = tc.from_numpy(_np(jc.default()), device=CPU)
        for name, arr in _np(jc.default()).items():
            np.testing.assert_array_equal(getattr(t, name).numpy(), arr)
        np.testing.assert_array_equal(t.flatten().numpy(), tc.default(CPU).flatten().numpy())
        back = tc.from_numpy(_np(t), device=CPU)
        np.testing.assert_array_equal(back.flatten().numpy(), t.flatten().numpy())

    def test_clamp_params_matches_reference(self):
        rng = np.random.default_rng(0)
        lo, hi = jparams.TechParams.bounds()
        d = {k: v * np.float32(10.0) ** rng.uniform(-2, 2, v.shape).astype(np.float32)
             for k, v in _np(jparams.TechParams.default()).items()}
        want = jparams.clamp_params(jparams.TechParams(**d), lo, hi)
        got = tparams.clamp_params(tparams.TechParams.from_numpy(d, device=CPU), *tparams.TechParams.bounds(CPU))
        for name, arr in _np(want).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), arr)

    def test_arch_spec_arrays(self):
        for spec in (tparams.ArchSpec(), tparams.ArchSpec(mem_type=("sram", "rram", "dram"))):
            jspec = jparams.ArchSpec(mem_type=spec.mem_type)
            np.testing.assert_array_equal(spec.mem_type_idx(), jspec.mem_type_idx())
            np.testing.assert_array_equal(spec.comp_mask(), jspec.comp_mask())


class TestGraphs:
    @pytest.mark.parametrize("name", CLASSIC)
    def test_workload_bit_equal(self, name):
        _assert_graph_equal(twl.get_workload(name, device=CPU), jwl.get_workload(name))

    @pytest.mark.parametrize("arch,shape", LM_CELLS)
    def test_lm_cell_bit_equal(self, arch, shape):
        _assert_graph_equal(twl.lm_cell(arch, shape, device=CPU), jwl.lm_cell(arch, shape))

    def test_workload_kwargs_pass_through(self):
        _assert_graph_equal(twl.get_workload("lstm", device=CPU, layers=2, mode="train"),
                            jwl.get_workload("lstm", layers=2, mode="train"))

    def test_pad_to_and_stack_bit_equal(self):
        jb, jl = jwl.get_workload("bert_base"), jwl.get_workload("lstm")
        tb, tl = twl.get_workload("bert_base", device=CPU), twl.get_workload("lstm", device=CPU)
        _assert_graph_equal(tb.pad_to(128), jb.pad_to(128))
        ts, js = tgraph.Graph.stack([tb, tl]), jgraph.Graph.stack([jb, jl])
        _assert_graph_equal(ts, js)
        assert ts.n_vertices == 109 and ts.n_comp.shape == (2, 109, 4)

    def test_compute_merge_bit_equal(self):
        tg = tgraph.workload_optimize(twl.get_workload("bert_base", device=CPU), 5e9)
        jg = jgraph.workload_optimize(jwl.get_workload("bert_base"), 5e9)
        _assert_graph_equal(tg, jg)
        assert tg.n_vertices < 109

    def test_graph_from_numpy_round_trips(self):
        jg = jwl.get_workload("dlrm")
        tg = tgraph.Graph.from_numpy(_graph_np(jg), names=jg.names, device=CPU)
        _assert_graph_equal(tg, jg)

    def test_model_flops_matches(self):
        from repro.configs import SHAPES as JSHAPES, get_config as jcfg
        from repro.core.trace import model_flops as jflops
        from repro_torch.configs import SHAPES, all_archs, get_config
        from repro_torch.core.trace import model_flops

        import repro.configs

        assert all_archs() == sorted(repro.configs.ALL_ARCH_IDS)
        for a in all_archs():
            for s in SHAPES:
                assert model_flops(get_config(a), SHAPES[s]) == jflops(jcfg(a), JSHAPES[s])
