"""The mapper's two kernels around K1 (``csrc/mapper.cu``) against the torch
stages they replace, on the card.

The kernels follow ``_vertex_intrinsics`` and ``_vertex_exec`` op for op, so
every per-vertex term is the torch path's bit for bit, K1 gets the same
inputs, and the gates agree: ``n_tiles`` (a sum of integers) is equal
exactly wherever it stays below 2**24, and every sum over V differs only by
its order (the kernel adds each warp's vertices in order, then the four
warps; ``torch.sum`` its own tree), held at rtol 1e-5 for these graphs' ≤
1,024 non-negative terms.  The torch path is reached on the same inputs by making
the kernels unreachable (``core.mapper.fused`` returning None).  Skipped
without a CUDA device; on the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_mapper_fused_gpu.py
"""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

CLASSIC = ["resnet50", "vgg16", "lstm", "dlrm", "bert_base", "bert_large", "gcn", "graphsage", "stencil2d",
           "merge_sort", "bfs_graph"]
LM = [("qwen2.5-32b", "prefill_32k"), ("granite-3-8b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
      ("falcon-mamba-7b", "long_500k"), ("zamba2-1.2b", "train_4k")]
RTOL = 1e-5
EXACT = ("n_tiles", "reads", "writes", "comp_ops", "peak_alloc")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ compiled by nvcc for sm_90a")
    from repro_torch.kernels import runtime

    return runtime.resolve_device(None)


@pytest.fixture(scope="module")
def graphs(cuda):
    from repro_torch.core import Graph
    from repro_torch.workloads import get_workload, lm_cell

    return {"classic": Graph.stack([get_workload(n, device=cuda).pad_to(256) for n in CLASSIC]),
            "lm_stack": Graph.stack([lm_cell(a, s, device=cuda).pad_to(1024) for a, s in LM])}


def _default_chw(cuda):
    from repro_torch.core import ArchParams, TechParams, specialize

    return specialize(TechParams.default(cuda), ArchParams.default(cuda))


def _population(chw, lead: tuple, seed: int, sigma: float = 0.5):
    """Designs with leading axes ``lead``: every field of ``chw`` scaled by
    exp(sigma * N(0, 1)), one draw an entry."""
    gen = torch.Generator(chw.frequency.device).manual_seed(seed)

    def jitter(x):
        z = torch.randn((*lead, *x.shape), generator=gen, device=x.device)
        return x * torch.exp(sigma * z)

    return type(chw)(**{f.name: jitter(getattr(chw, f.name)) for f in dataclasses.fields(chw)})


def _torch_path(monkeypatch, fn):
    from repro_torch.core import mapper

    with monkeypatch.context() as m:
        m.setattr(mapper, "fused", lambda chw, g: None)
        return fn()


def _launches():
    from repro_torch.kernels import runtime

    return {k: runtime.LAUNCHES[k] for k in ("mapper_intrinsics", "mapper_finish", "mapper_carries")}


def _check_states(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, (f.name, a.shape, b.shape)
        assert torch.equal(torch.isfinite(a), torch.isfinite(b)), f.name
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f.name
        fin = torch.isfinite(b)
        if f.name in EXACT:  # sums of integers: exact in any order below 2**24
            small = fin & (b.abs() < 2.0 ** 24)
            assert torch.equal(a[small], b[small]), f.name
        torch.testing.assert_close(a[fin], b[fin], rtol=RTOL, atol=0, msg=f.name)


def _fused_against_torch(monkeypatch, chw, g, cfg):
    from repro_torch.core import mapper

    before = _launches()
    with torch.no_grad():
        got = mapper.map_workload(chw, g, cfg)
    torch.cuda.synchronize()
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == {"mapper_intrinsics": 1, "mapper_finish": 1,
                                                        "mapper_carries": 1}
    with torch.no_grad():
        want = _torch_path(monkeypatch, lambda: mapper.map_workload(chw, g, cfg))
    _check_states(got, want)
    return got


def _cfgs():
    from repro_torch.core import MapperCfg

    return {"default": MapperCfg(), "no_prefetch": MapperCfg(prefetch=False),
            "no_streaming": MapperCfg(streaming=False), "headroom_0.7": MapperCfg(headroom=0.7)}


@pytest.mark.parametrize("cfg", ["default", "no_prefetch", "no_streaming", "headroom_0.7"])
@pytest.mark.parametrize("stack", ["classic", "lm_stack"])
def test_population_against_the_torch_stages(cuda, graphs, monkeypatch, stack, cfg):
    # P = 4,096 designs [P, 1] against [11, 256] and [5, 1024]
    chw = _population(_default_chw(cuda), (4096, 1), seed=len(stack) * 31 + len(cfg))
    ms = _fused_against_torch(monkeypatch, chw, graphs[stack], _cfgs()[cfg])
    assert bool(torch.isfinite(ms.cycles).all())


@pytest.mark.parametrize("V", [32, 1024])
def test_design_service_batches(cuda, monkeypatch, V):
    # the design service's batched report: designs [16, 1] against one graph
    # row each, [16, 1, V] (one query a row at request bucket 16)
    from repro_torch.core import Graph
    from repro_torch.workloads import get_workload, lm_cell

    if V == 32:
        names = ["lstm", "merge_sort", "bfs_graph", "stencil2d"] * 4
        rows = [get_workload(n, device=cuda) for n in names]
    else:
        rows = [lm_cell(*LM[i % len(LM)], device=cuda) for i in range(16)]
    rows = [g for g in rows if g.n_vertices <= V]
    assert len(rows) == 16
    g = Graph.stack([Graph.stack([r.pad_to(V)]) for r in rows])
    chw = _population(_default_chw(cuda), (16, 1), seed=V)
    ms = _fused_against_torch(monkeypatch, chw, g, _cfgs()["default"])
    assert ms.cycles.shape == (16, 1)


def test_one_design_on_one_graph(cuda, monkeypatch):
    from repro_torch.workloads import lm_cell

    g = lm_cell("qwen2.5-32b", "prefill_32k", device=cuda).pad_to(1024)
    ms = _fused_against_torch(monkeypatch, _default_chw(cuda), g, _cfgs()["default"])
    assert ms.cycles.shape == ()


def test_designs_straddling_the_tiling_threshold(cuda, graphs, monkeypatch):
    # the capacity a few ulps either side of alloc / (k * headroom) on each
    # workload's largest allocation: tiles = k or k + 1, decided alike
    g = graphs["classic"]
    alloc = g.n_alloc[..., 1].amax(-1)  # [W]
    k = torch.arange(1, 5, device=cuda, dtype=torch.float32)
    ulps = torch.arange(-3, 4, device=cuda, dtype=torch.float32) * 2.0 ** -23
    cap = (alloc[None, None, :] / (k[:, None, None] * 0.9)) * (1 + ulps[None, :, None])  # [4, 7, W]
    cap = cap.reshape(-1, 1)  # a design a (k, ulps, workload): that workload's threshold
    chw = _population(_default_chw(cuda), (cap.shape[0], 1), seed=5, sigma=0.0)
    capacity = chw.capacity.clone()
    capacity[..., 1] = cap
    chw = dataclasses.replace(chw, capacity=capacity)
    ms = _fused_against_torch(monkeypatch, chw, g, _cfgs()["no_streaming"])
    assert len(torch.unique(ms.n_tiles)) > 1


def test_non_finite_designs(cuda, graphs, monkeypatch):
    chw = _population(_default_chw(cuda), (8, 1), seed=9)
    freq, bw, cap, fpc = (x.clone() for x in (chw.frequency, chw.mem_bw, chw.capacity, chw.flops_per_cycle))
    freq[0] = float("inf")
    bw[1, ..., 1] = 0.0
    cap[2, ..., 1] = float("nan")
    fpc[3, ..., 2] = float("inf")
    cap[4, ..., 1] = float("inf")
    chw = dataclasses.replace(chw, frequency=freq, mem_bw=bw, capacity=cap, flops_per_cycle=fpc)
    ms = _fused_against_torch(monkeypatch, chw, graphs["classic"], _cfgs()["default"])
    assert not bool(torch.isfinite(ms.cycles[:3]).all()) and bool(torch.isfinite(ms.cycles[5:]).all())


def test_the_grad_path_takes_the_torch_stages(cuda, graphs, monkeypatch):
    from repro_torch.core import mapper

    chw = _population(_default_chw(cuda), (64, 1), seed=11)

    def run():
        leaves = {f: getattr(chw, f).clone().requires_grad_(True) for f in ("frequency", "mem_bw", "capacity")}
        ms = mapper.map_workload(dataclasses.replace(chw, **leaves), graphs["lm_stack"])
        (ms.cycles.sum() + ms.t_exposed_main.sum()).backward()
        return ms, {f: x.grad for f, x in leaves.items()}

    before = _launches()
    ms, grads = run()
    torch.cuda.synchronize()
    after = _launches()
    assert after["mapper_intrinsics"] == before["mapper_intrinsics"]
    assert after["mapper_finish"] == before["mapper_finish"]
    assert after["mapper_carries"] == before["mapper_carries"] + 1
    ms0, grads0 = _torch_path(monkeypatch, run)
    for f in dataclasses.fields(ms0):
        assert torch.equal(getattr(ms, f.name), getattr(ms0, f.name)), f.name
    for f in grads0:
        assert torch.equal(grads[f], grads0[f]), f


def test_ops_against_their_plain_versions(cuda, graphs):
    # the ops on the card against their CPU registrations on the same packed rows
    from repro_torch.core import mapper
    from repro_torch.kernels import mapper_kernel

    chw = _population(_default_chw(cuda), (96, 1), seed=13)
    g = graphs["classic"]
    fz = mapper.pack(chw, g)
    bw_x = mapper_kernel.mapper_intrinsics_op(fz.graph, fz.designs, fz.span, 0.9)
    want = mapper_kernel.mapper_intrinsics_op(fz.graph.cpu(), fz.designs.cpu(), fz.span, 0.9)
    torch.testing.assert_close(bw_x.cpu(), want, rtol=0, atol=0)
    occ, bwp = mapper._carry_prefixes(chw, mapper.MapperCfg(), dict(alloc_gbuf=g.n_alloc[..., 1],
                                                                   bw_x=bw_x.view(96, 11, 256)))
    R = 96 * 11
    sums, bw_util = mapper_kernel.mapper_finish_op(fz.graph, fz.designs, occ.reshape(R, 256), bwp.reshape(R, 256),
                                                   fz.span, 0.9, True, True)
    ws, wb = mapper_kernel.mapper_finish_op(fz.graph.cpu(), fz.designs.cpu(), occ.reshape(R, 256).cpu(),
                                            bwp.reshape(R, 256).cpu(), fz.span, 0.9, True, True)
    torch.testing.assert_close(sums.cpu(), ws, rtol=RTOL, atol=0)
    torch.testing.assert_close(bw_util.cpu(), wb, rtol=RTOL, atol=0)
    assert torch.equal(sums[4].cpu(), ws[4])  # n_tiles
