"""The mapper's kernels around K1 (``kernels/mapper_kernel.py``) on the CPU:
their ops' plain versions, the packing of a call's inputs, the fake
registration and the predicate that decides whether the kernels engage.

On the CPU the ops run their plain versions, so these tests hold the packing,
the row indexing and the MapState assembly of the no-gradient path against
the sequential oracle ``map_workload_scan`` at the mapper's tolerance (rtol
1e-5, ``tests/test_mapper_equiv.py``), with the predicate's device check made
to accept CPU tensors.  The kernels themselves are held against the torch
stages on the card (``tests/test_torch_mapper_fused_gpu.py``).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import ArchParams, Graph, MapperCfg, TechParams, mapper, specialize
from repro_torch.kernels import mapper_kernel, runtime
from repro_torch.workloads import get_workload

CPU = "cpu"
CFGS = {"default": MapperCfg(), "no_prefetch": MapperCfg(prefetch=False),
        "no_streaming": MapperCfg(streaming=False), "headroom_0.7": MapperCfg(headroom=0.7)}


def _chw():
    return specialize(TechParams.default(CPU), ArchParams.default(CPU))


def _designs(lead: tuple, seed: int, sigma: float = 0.6):
    chw = _chw()
    gen = torch.Generator().manual_seed(seed)

    def jitter(x):
        return x * torch.exp(sigma * torch.randn((*lead, *x.shape), generator=gen))

    return type(chw)(**{f.name: jitter(getattr(chw, f.name)) for f in dataclasses.fields(chw)})


def _random_graph(V: int, n_real: int, seed: int) -> Graph:
    """A graph of ``n_real`` vertices of non-negative counts, a third of the
    entries zero, padded with no-op vertices to V."""
    gen = torch.Generator().manual_seed(seed)

    def draw(k, scale):
        x = torch.exp(torch.randn(n_real, k, generator=gen) * 2.0) * scale
        return x * (torch.rand(n_real, k, generator=gen) > 0.33)

    g = Graph(n_comp=draw(4, 1e9), n_read=draw(3, 1e7), n_write=draw(3, 1e7), n_alloc=draw(3, 3e6),
              dims=torch.ceil(torch.rand(n_real, 3, generator=gen) * 4096.0),
              op_kind=torch.zeros(n_real, dtype=torch.int32), edges=torch.zeros(0, 2, dtype=torch.int32))
    return g.pad_to(V)


def _stack(kind: str) -> Graph:
    if kind == "classic":
        return Graph.stack([get_workload(n, device=CPU).pad_to(256) for n in ("lstm", "bert_base", "gcn")])
    return Graph.stack([_random_graph(64, n, seed=n) for n in (64, 40, 17)])


@pytest.fixture
def on_card(monkeypatch):
    """The predicate's device check accepts CPU float32 tensors: the
    no-gradient path then runs the ops' plain versions."""
    monkeypatch.setattr(mapper, "_on_card", lambda t: t.dtype == torch.float32)
    calls = []
    real = mapper.fused
    monkeypatch.setattr(mapper, "fused", lambda chw, g: calls.append(real(chw, g)) or calls[-1])
    return calls


def _close(got, want, rtol=1e-5):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        torch.testing.assert_close(a, b, rtol=rtol, atol=0, msg=f.name)


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("stack", ["classic", "random"])
def test_population_against_the_oracle(on_card, stack, cfg):
    # designs [P, 1] against a [W, V] stack: row r = design r // W, graph r % W
    g, chw = _stack(stack), _designs((6, 1), seed=len(cfg))
    with torch.no_grad():
        got = mapper.map_workload(chw, g, CFGS[cfg])
    assert on_card and on_card[-1] is not None and on_card[-1].span == 3
    _close(got, mapper.map_workload_scan(chw, g, CFGS[cfg]))


@pytest.mark.parametrize("layout", ["one_design_one_graph", "one_design_a_stack", "batched_requests",
                                    "designs_against_one_graph"])
def test_layouts_against_the_oracle(on_card, layout):
    W = _stack("random")
    one = _random_graph(48, 30, seed=7)
    g, lead = {"one_design_one_graph": (one, ()), "one_design_a_stack": (W, ()),
               "batched_requests": (Graph.stack([W, _stack("random")]), (2, 1)),
               "designs_against_one_graph": (one, (5,))}[layout]
    chw = _designs(lead, seed=3) if lead else _chw()
    with torch.no_grad():
        got = mapper.map_workload(chw, g)
    assert on_card[-1] is not None
    _close(got, mapper.map_workload_scan(chw, g))


def test_ops_plain_versions_against_the_torch_stages():
    # the plain versions are the torch stages on the gathered rows: bit for bit
    g, chw = _stack("random"), _designs((4, 1), seed=11)
    cfg = MapperCfg()
    fz = mapper.pack(chw, g)
    assert fz.graph.shape == (3, 64, mapper_kernel.GRAPH_COLS) and fz.designs.shape == (4, mapper_kernel.DESIGN_COLS)
    bw_x = mapper_kernel.mapper_intrinsics_op(fz.graph, fz.designs, fz.span, cfg.headroom)
    iv = mapper._vertex_intrinsics(mapper._hw(chw), g, cfg)
    assert torch.equal(bw_x, iv["bw_x"].reshape(12, 64))
    occ, bwp = mapper._carry_prefixes(chw, cfg, iv)
    sums, bw_util = mapper_kernel.mapper_finish_op(fz.graph, fz.designs, occ.reshape(12, 64), bwp.reshape(12, 64),
                                                   fz.span, cfg.headroom, cfg.prefetch, cfg.streaming)
    want = mapper._vertex_finish(mapper._hw(chw), g, cfg, iv, occ, bwp)
    for i, f in enumerate(mapper_kernel.SUMS):
        assert torch.equal(sums[i], getattr(want, f).reshape(12)), f
    assert torch.equal(bw_util, want.bw_util.reshape(12, 3))


def test_fake_registrations_give_the_shapes():
    with FakeTensorMode():
        graph, designs = torch.empty(3, 40, mapper_kernel.GRAPH_COLS), torch.empty(5, mapper_kernel.DESIGN_COLS)
        bw_x = mapper_kernel.mapper_intrinsics_op(graph, designs, 3, 0.9)
        sums, bw_util = mapper_kernel.mapper_finish_op(graph, designs, bw_x, bw_x, 3, 0.9, True, False)
    assert bw_x.shape == (15, 40) and sums.shape == (len(mapper_kernel.SUMS), 15) and bw_util.shape == (15, 3)
    assert bw_x.dtype == sums.dtype == bw_util.dtype == torch.float32


def test_ops_refuse_what_the_kernels_do_not_take():
    graph, designs = torch.zeros(3, 40, mapper_kernel.GRAPH_COLS), torch.ones(5, mapper_kernel.DESIGN_COLS)
    with pytest.raises(TypeError):
        mapper_kernel.mapper_intrinsics_op(graph.double(), designs, 3, 0.9)
    with pytest.raises(ValueError, match="do not cover"):
        mapper_kernel.mapper_intrinsics_op(graph, designs, 2, 0.9)  # 10 rows against 3 graph rows
    with pytest.raises(ValueError, match="not \\[15, 40\\]"):
        mapper_kernel.mapper_finish_op(graph, designs, torch.zeros(15, 39), torch.zeros(15, 39), 3, 0.9, True, True)
    with pytest.raises(ValueError):
        mapper_kernel.mapper_intrinsics_op(graph[..., :15], designs, 3, 0.9)


def test_the_kernels_are_registered():
    assert runtime.SOURCES["mapper"] == "mapper.cu" and "--fmad=false" in runtime.flags("mapper")
    assert {"mapper_intrinsics", "mapper_finish"} <= set(runtime.LAUNCHES) and "mapper" not in runtime.LAUNCHES
    text = (runtime.CSRC / "mapper.cu").read_text()
    assert all(f"{entry}(" in text for entry in runtime._ENTRY["mapper"])


def test_predicate_falls_back_on_cpu_tensors():
    g, chw = _stack("random"), _designs((4, 1), seed=1)
    with torch.no_grad():
        assert mapper.fused(chw, g) is None
    assert mapper.pack(chw, g) is not None


def test_predicate_falls_back_where_a_gradient_is_needed(on_card):
    g, chw = _stack("random"), _designs((4, 1), seed=2)
    leaf = dataclasses.replace(chw, frequency=chw.frequency.clone().requires_grad_(True))
    assert mapper.fused(leaf, g) is None  # grad on, an input requires grad
    with torch.no_grad():
        assert mapper.fused(leaf, g) is not None
    assert mapper.fused(chw, g) is not None  # grad on, no input requires grad
    ms = mapper.map_workload(leaf, g)
    ms.cycles.sum().backward()
    assert leaf.frequency.grad is not None and on_card[-1] is None


def test_predicate_falls_back_below_the_scan_threshold(on_card):
    chw = _designs((4, 1), seed=4)
    with torch.no_grad():
        mapper.map_workload(chw, Graph.stack([_random_graph(16, 12, seed=5)]))
        assert not on_card  # "auto" takes the sequential loop below 32 vertices
        mapper.map_workload(chw, Graph.stack([_random_graph(32, 12, seed=5)]))
        assert on_card and on_card[-1] is not None


@pytest.mark.parametrize("case", ["graph_outer_designs_inner", "graph_fields_differ", "float64"])
def test_predicate_falls_back_on_other_layouts(on_card, case):
    g = Graph.stack([_random_graph(40, 20, seed=8)])  # [1, V]
    chw = _designs((3,), seed=6)
    if case == "graph_outer_designs_inner":  # graphs [2, 1, V] against designs [3]: rows [2, 3]
        g = Graph.stack([g, g])
    elif case == "graph_fields_differ":
        g = dataclasses.replace(g, dims=g.dims[0])
    else:
        g = dataclasses.replace(g, n_comp=g.n_comp.double())
    if case != "float64":
        assert mapper.pack(chw, g) is None
    with torch.no_grad():
        assert mapper.fused(chw, g) is None
        if case == "graph_outer_designs_inner":  # the torch stages still answer
            _close(mapper.map_workload(chw, g), mapper.map_workload_scan(chw, g))


def test_the_kernels_module_leaves_the_mapper_to_its_caller():
    # the dependency runs one way: core.mapper packs, calls and registers the
    # plain versions; the kernels module knows only the packed layout
    text = (runtime.CSRC.parent / "mapper_kernel.py").read_text()
    assert "repro_torch.core" not in text and "import mapper" not in text
    assert mapper_kernel.DESIGN_COLS == sum(mapper._HW_COLS.values())
    assert mapper_kernel.GRAPH_COLS == sum(mapper._GRAPH_WIDTHS)
