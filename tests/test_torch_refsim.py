"""Port conformance: the float64 reference cycle walker, against the
reference package's walker, and the port's DSim against the port's walker.

The matrix is tests/test_refsim_accuracy.py's: 11 workloads of every family on
the base, datacenter and edge library archs.  The two walkers read ConcreteHW
fields that the two packages compute to within ulps, so they agree to rtol
1e-5; DSim tracks the walker within that file's per-workload tolerances.
"""
import numpy as np
import pytest

import repro.core.dhdl as jdhdl
import repro.core.refsim as jrefsim
import repro.workloads as jwl
import repro_torch.core.dhdl as tdhdl
import repro_torch.core.refsim as trefsim
import repro_torch.workloads as twl

CPU = "cpu"
# workload -> DSim-vs-walker relative tolerance (tests/test_refsim_accuracy.py)
MATRIX = {
    "resnet50": 0.05, "lstm": 0.08, "bert_base": 0.03, "dlrm": 0.06, "gcn": 0.08, "graphsage": 0.09,
    "stencil2d": 0.08, "merge_sort": 0.08, "bfs_graph": 0.06, "granite-3-8b:train_4k": 0.02,
    "qwen2.5-32b:prefill_32k": 0.02,
}
ARCHS = ["base", "datacenter", "edge"]


def _graph(wl, name, **kw):
    return wl.lm_cell(*name.split(":"), **kw) if ":" in name else wl.get_workload(name, **kw)


@pytest.fixture(scope="module")
def pairs():
    """(port graph, reference graph) per workload; (port arch, reference arch,
    their specialized ConcreteHW) per arch — built once."""
    graphs = {n: (_graph(twl, n, device=CPU), _graph(jwl, n)) for n in MATRIX}
    archs = {}
    for a in ARCHS:
        t, j = tdhdl.load_arch(a, CPU), jdhdl.load_arch(a)
        archs[a] = (t, j, t.specialize(), j.specialize())
    return graphs, archs


@pytest.fixture(scope="module")
def walks(pairs):
    graphs, archs = pairs
    return {(w, a): (trefsim.reference_simulate(archs[a][2], graphs[w][0]),
                     jrefsim.reference_simulate(archs[a][3], graphs[w][1]))
            for w in MATRIX for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("workload", sorted(MATRIX))
def test_walker_matches_reference_walker(walks, workload, arch):
    got, want = walks[workload, arch]
    for k in ("cycles", "runtime", "energy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("workload", sorted(MATRIX))
def test_port_dsim_tracks_port_walker(pairs, walks, workload, arch):
    graphs, archs = pairs
    cyc = float(archs[arch][0].simulate(graphs[workload][0]).cycles)
    want = walks[workload, arch][0]["cycles"]
    rel = abs(cyc - want) / max(want, 1.0)
    assert rel <= MATRIX[workload], f"{workload} on {arch}: DSim {cyc:.4g} vs walker {want:.4g} (rel {rel:.4f})"


def test_walker_reads_tensors_as_float64_on_the_host(pairs):
    graphs, archs = pairs
    out = trefsim.reference_simulate(archs["edge"][2], graphs["lstm"][0], headroom=0.5)
    assert all(isinstance(v, float) for v in out.values())
    want = jrefsim.reference_simulate(archs["edge"][3], graphs["lstm"][1], headroom=0.5)
    np.testing.assert_allclose(out["cycles"], want["cycles"], rtol=1e-5)
