"""Port conformance: the popsim packers and the population kernel's plain
version against the reference kernel (interpret mode) and its oracle, on
populations that scale cell_read_latency and on populations that scale the
global buffer's bandwidth 0.01x-100x, where the bandwidth-EMA gate switches.

Tolerance: rtol 1e-5, atol 1e-3, as tests/test_kernels.py holds the kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dgen as jdgen
import repro.core.params as jparams
import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro.workloads as jwl
import repro_torch.core.dgen as tdgen
import repro_torch.core.mapper as tmapper
import repro_torch.core.params as tparams
import repro_torch.kernels.ops as tops
import repro_torch.kernels.popsim_kernel as tpk
import repro_torch.kernels.ref as tref
import repro_torch.workloads as twl

CPU = "cpu"


def _populations(P: int):
    scales = np.linspace(0.5, 2.0, P, dtype=np.float32)
    jt, ja = jparams.TechParams.default(), jparams.ArchParams.default()
    jc = jax.vmap(lambda s: jdgen.specialize(
        dataclasses.replace(jt, cell_read_latency=jt.cell_read_latency * s), ja))(jnp.asarray(scales))
    tt, ta = tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU)
    tt.cell_read_latency = tt.cell_read_latency * torch.tensor(scales)[:, None]
    return tops.pack_chw(tdgen.specialize(tt, ta)), jops.pack_chw(jc)


# populations whose global-buffer bandwidth is scaled 0.01x-100x: on bert_base
# the bandwidth EMA's gate stays open, shuts after the first vertices, or opens
# and shuts along one walk, by design
BW_P = 16


def _bw_scales(P: int) -> np.ndarray:
    return np.logspace(-2, 2, P).astype(np.float32)


def _bw_populations(P: int):
    tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
    jc = jdgen.specialize(jparams.TechParams.default(), jparams.ArchParams.default())
    gbuf = tpk.BW.start + tpk._GBUF
    tcp = tops.pack_chw(tc).expand(P, -1).clone()
    tcp[:, gbuf] = tcp[:, gbuf] * torch.from_numpy(_bw_scales(P))
    jcp = jnp.broadcast_to(jops.pack_chw(jc), (P, tpk.CHW_COLS))
    jcp = jcp.at[:, gbuf].multiply(jnp.asarray(_bw_scales(P)))
    return tcp, jcp


GRAPHS = {
    "bert_base": lambda: (twl.get_workload("bert_base", device=CPU), jwl.get_workload("bert_base")),
    "lstm_padded": lambda: (twl.get_workload("lstm", device=CPU).pad_to(32), jwl.get_workload("lstm").pad_to(32)),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for gname, make in GRAPHS.items():
        tg, jg = make()
        tgp, jgp = tops.pack_graph(tg), jops.pack_graph(jg)
        for P, pop in ((8, _populations), (64, _populations), ("bw", _bw_populations)):
            tcp, jcp = pop(BW_P if P == "bw" else P)
            out[gname, P] = dict(
                tgp=tgp, jgp=jgp, tcp=tcp, jcp=jcp,
                got=tops.popsim(tgp, tcp),
                kernel=np.asarray(jops.popsim(jgp, jcp)),
                oracle=np.asarray(jref.popsim_reference(jgp, jcp)),
            )
    return out


class TestPacking:
    def test_pack_graph_bit_equal(self, runs):
        for r in runs.values():
            np.testing.assert_array_equal(r["tgp"].numpy(), np.asarray(r["jgp"]))

    def test_pack_chw_population(self, runs):
        for r in runs.values():
            np.testing.assert_allclose(r["tcp"].numpy(), np.asarray(r["jcp"]), rtol=1e-6)

    def test_pack_chw_single_design(self):
        tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        jc = jdgen.specialize(jparams.TechParams.default(), jparams.ArchParams.default())
        got, want = tops.pack_chw(tc), np.asarray(jops.pack_chw(jc))
        assert got.shape == (1, tpk.CHW_COLS)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    def test_layout_constants_match(self):
        import repro.kernels.popsim_kernel as jpk

        for name in ("FREQ", "CAP_GBUF", "BW", "RLAT", "WLAT", "RE_PB", "WE_PB", "E_FLOP", "RATE",
                     "SYS_X", "SYS_Y", "CHW_COLS", "G_COMP", "G_READ", "G_WRITE", "G_ALLOC_GBUF",
                     "G_MAIN_PRESENT", "G_DIMS", "GRAPH_COLS", "OUT_COLS", "HEADROOM"):
            assert getattr(tpk, name) == getattr(jpk, name), name


class TestPopsimPlain:
    @pytest.mark.parametrize("P", [8, 64])
    @pytest.mark.parametrize("gname", list(GRAPHS))
    def test_matches_reference_kernel_and_oracle(self, runs, gname, P):
        r = runs[gname, P]
        got = r["got"].numpy()
        assert got.shape == (P, tpk.OUT_COLS)
        np.testing.assert_allclose(got, r["kernel"], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got, r["oracle"], rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("gname", list(GRAPHS))
    def test_gbuf_bandwidth_designs_match_reference_kernel_and_oracle(self, runs, gname):
        r = runs[gname, "bw"]
        got = r["got"].numpy()
        assert got.shape == (BW_P, tpk.OUT_COLS)
        np.testing.assert_allclose(got, r["kernel"], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got, r["oracle"], rtol=1e-5, atol=1e-3)

    def test_gbuf_bandwidth_designs_switch_the_gate(self):
        """On bert_base the scaled designs hold the gate open all along, shut
        it after the first vertices, and open and shut it along one walk (the
        mapper's bandwidth EMA before each vertex, the same recurrence)."""
        g = twl.get_workload("bert_base", device=CPU)
        chw = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        factor = torch.ones(BW_P, 3)
        factor[:, tpk._GBUF] = torch.from_numpy(_bw_scales(BW_P))
        chw = dataclasses.replace(chw, mem_bw=chw.mem_bw * factor)
        cfg = tmapper.MapperCfg()
        iv = tmapper._vertex_intrinsics(tmapper._hw(chw), g, cfg)
        _, bw_prev = tmapper._carry_prefixes(chw, cfg, iv)
        gate = (bw_prev < tpk.HEADROOM)[:, iv["active"] > 0]
        flips = (gate[:, 1:] != gate[:, :-1]).sum(-1)
        assert bool(gate.all(-1).any())  # open at every vertex
        assert bool(((flips == 1) & gate[:, 0]).any())  # shut after the first vertices
        assert int(flips.max()) >= 2  # opens and shuts along one walk

    def test_wrapper_takes_plain_version_on_cpu(self, runs):
        r = runs["bert_base", 8]
        np.testing.assert_array_equal(r["got"].numpy(), tref.popsim_reference(r["tgp"], r["tcp"]).numpy())

    def test_bad_layouts_raise(self, runs):
        r = runs["bert_base", 8]
        with pytest.raises(ValueError):
            tops.popsim(r["tgp"][:, :15], r["tcp"])
        with pytest.raises(ValueError):
            tops.popsim(r["tgp"], r["tcp"][:, :26])
        with pytest.raises(TypeError):
            tops.popsim(r["tgp"].double(), r["tcp"])
