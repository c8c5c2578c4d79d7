"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip (the CPU suite holds
the plain versions against the reference package instead).  On the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine lacks.)
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ compiled by nvcc for sm_90a")
    from repro_torch.kernels import runtime

    return runtime.resolve_device(None)


@pytest.mark.parametrize("R,V", [(1, 1), (3, 33), (16, 707), (5, 1024), (11, 256), (1, 32), (1, 1024)])
def test_affine_scan_kernel_matches_plain(cuda, R, V):
    from repro_torch.kernels import ref, runtime, sscan

    gen = torch.Generator("cuda").manual_seed(R * 10007 + V)
    b = (0.4 * torch.rand(R, V, generator=gen, device=cuda)).requires_grad_(True)
    cot = torch.rand(R, V, generator=gen, device=cuda)
    before = runtime.LAUNCHES["affine_scan"]
    s = sscan.affine_scan(0.8, b)
    (s * cot).sum().backward()
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["affine_scan"] == before + 2  # forward + reversed backward
    want = ref.affine_scan_reference(0.8, b.detach())
    want_g = ref.affine_scan_reference(0.8, cot, reverse=True)
    torch.testing.assert_close(s.detach(), want, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    torch.testing.assert_close(b.grad, want_g, rtol=1e-5, atol=1e-6 * float(cot.abs().max()))


# K1's fused kernels: the mapper's two carries forward (values and clamp
# codes) and their closed-form backward, at the affine scan's shapes, two
# rows of several tiles (1,024 elements a tile), rows clamping often, and the
# DSE path's populations, P·W rows: [96, 109]
# (32 members x 3 workloads at the bench configuration) and [5120, 1024]
# (1,024 members on the LM stack), and the design service's, one row a query
# at its pinned request bucket of 16: [16, 32] and [16, 1024]
_CARRY_SHAPES = [(1, 1), (3, 33), (16, 707), (5, 1024), (11, 256), (1, 32), (1, 1024), (2, 4096), (3, 2500),
                 (96, 109), (5120, 1024), (16, 32), (16, 1024)]


def _carries_decays():
    from repro_torch.core import mapper

    return mapper._OCC_DECAY, mapper._BW_DECAY, mapper._BW_GAIN


def _carries_draw(cuda, R, V, per_row_cap, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    rand = lambda *s: torch.rand(*s, generator=gen, device=cuda)  # noqa: E731
    cap = 1.0 + 2.0 * rand(R if per_row_cap else ())
    alloc = cap.reshape(-1, 1) * (0.2 + 0.7 * rand(R, V))  # a steady state of 2*alloc: clamps often
    return alloc, 2.0 * rand(R, V), cap, rand(R, V) - 0.5, rand(R, V) - 0.5


def _carry_names():
    return ("mapper_carries", "mapper_carries_backward")


@pytest.mark.parametrize("per_row_cap", [False, True], ids=["scalar_cap", "row_cap"])
@pytest.mark.parametrize("R,V", _CARRY_SHAPES)
def test_mapper_carries_kernel_matches_plain(cuda, R, V, per_row_cap):
    from repro_torch.kernels import ref, runtime, sscan

    decays = _carries_decays()
    alloc, bw_x, cap, w_occ, w_bw = _carries_draw(cuda, R, V, per_row_cap, R * 10007 + V)
    leaves = [t.clone().requires_grad_(True) for t in (alloc, bw_x, cap)]
    before = {n: runtime.LAUNCHES[n] for n in _carry_names()}
    occ, bw = sscan.mapper_carries(*leaves, *decays)
    (occ * w_occ + bw * w_bw).sum().backward()
    torch.cuda.synchronize()
    assert {n: runtime.LAUNCHES[n] - before[n] for n in _carry_names()} == {n: 1 for n in _carry_names()}

    want_occ, want_bw, want_code = ref.mapper_carries_reference(alloc, bw_x, cap, *decays)
    _, _, code = sscan.mapper_carries_op(alloc, bw_x, cap.reshape(-1), *decays)
    assert code.dtype == torch.uint8 and torch.equal(code, want_code)
    if V >= 256:
        assert 0.05 < float((code == 0).float().mean()) < 0.95  # both sides of the clamp
    for got, want in ((occ, want_occ), (bw, want_bw)):
        torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    ga, gb, gc = ref.mapper_carries_backward_reference(w_occ, w_bw, want_code, *decays)
    gc = gc if per_row_cap else gc.sum()
    for got, want in ((leaves[0].grad, ga), (leaves[1].grad, gb)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    lam_abs = ref.mapper_carries_backward_reference(w_occ.abs(), w_bw.abs(), want_code, *decays)[2].sum()
    assert leaves[2].grad.shape == cap.shape
    torch.testing.assert_close(leaves[2].grad, gc, rtol=1e-5, atol=1e-6 * float(lam_abs) + 1e-30)


def test_mapper_carries_backward_without_alloc(cuda):
    # the mapper's own case: the graph's allocations take no gradient, so the
    # kernel writes no grad_alloc
    from repro_torch.kernels import ref, runtime, sscan

    decays = _carries_decays()
    alloc, bw_x, cap, w_occ, w_bw = _carries_draw(cuda, 5, 1024, False, 3)
    bw_l, cap_l = bw_x.clone().requires_grad_(True), cap.clone().requires_grad_(True)
    before = runtime.LAUNCHES["mapper_carries_backward"]
    occ, bw = sscan.mapper_carries(alloc, bw_l, cap_l, *decays)
    (occ * w_occ + bw * w_bw).sum().backward()
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["mapper_carries_backward"] == before + 1
    _, _, code = ref.mapper_carries_reference(alloc, bw_x, cap, *decays)
    _, gb, gc = ref.mapper_carries_backward_reference(w_occ, w_bw, code, *decays)
    torch.testing.assert_close(bw_l.grad, gb, rtol=1e-5, atol=1e-6 * float(gb.abs().max()))
    torch.testing.assert_close(cap_l.grad, gc.sum(), rtol=1e-5, atol=1e-5 * float(gc.abs().sum()))


def test_mapper_carries_ties_on_the_card(cuda):
    # powers of two: every u = 0.5*s + alloc that meets cap meets it exactly,
    # in the kernel and in the plain version alike; a tie splits as torch.minimum
    from repro_torch.kernels import ref, sscan

    decays = _carries_decays()
    cap = torch.tensor([4.0], device=cuda)
    alloc = torch.tensor([[4.0, 2.0, 2.0, 1.0, 3.0, 2.0, 0.5, 8.0, 2.0]], device=cuda)
    bw_x = torch.full_like(alloc, 0.5)
    _, _, code = sscan.mapper_carries_op(alloc, bw_x, cap, *decays)
    want = ref.mapper_carries_reference(alloc, bw_x, cap, *decays)
    assert torch.equal(code, want[2]) and int((code == 1).sum()) == 5
    leaves = [t.clone().requires_grad_(True) for t in (alloc, bw_x, cap)]
    occ, _ = sscan.mapper_carries(*leaves, *decays)
    w = torch.arange(1.0, 10.0, device=cuda)[None]
    (occ * w).sum().backward()
    ga, _, gc = ref.mapper_carries_backward_reference(w, torch.zeros_like(w), code, *decays)
    torch.testing.assert_close(occ.detach(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(leaves[0].grad, ga, rtol=0, atol=0)
    torch.testing.assert_close(leaves[2].grad, gc, rtol=0, atol=0)


def test_mapper_carries_launch_nothing_on_empty_rows_and_raise_on_bad_inputs(cuda):
    from repro_torch.kernels import runtime, sscan

    decays = _carries_decays()
    before = dict(runtime.LAUNCHES)
    occ, bw = sscan.mapper_carries(torch.rand(3, 0, device=cuda), torch.rand(3, 0, device=cuda),
                                   torch.ones(3, device=cuda), *decays)
    assert occ.shape == bw.shape == (3, 0)
    occ, bw = sscan.mapper_carries(torch.rand(0, 5, device=cuda), torch.rand(0, 5, device=cuda),
                                   torch.ones((), device=cuda), *decays)
    assert occ.shape == bw.shape == (0, 5)
    x = torch.rand(3, 8, device=cuda)
    with pytest.raises(TypeError):
        sscan.mapper_carries(x.double(), x, torch.ones(3, device=cuda), *decays)
    with pytest.raises(TypeError):
        sscan.mapper_carries_backward_op(x, x, x, *decays, True)  # the code must be uint8
    with pytest.raises(ValueError, match="one device"):
        sscan.mapper_carries(x.cpu(), x, torch.ones(3, device=cuda), *decays)
    with pytest.raises(ValueError, match="occ_decay"):
        sscan.mapper_carries(x, x, torch.ones(3, device=cuda), -0.5, *decays[1:])
    torch.cuda.synchronize()
    assert runtime.LAUNCHES == before


# popsim (K2) is held to its plain version bit for bit: it keeps the plain
# version's operation order, IEEE '/' and ceilf, and contracts nothing
def _popsim_exact(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _popsim_graph(name, dev):
    from repro_torch.kernels import ops
    from repro_torch.workloads import get_workload, lm_cell

    if name == "bert_base-300":  # spans two graph tiles
        return ops.pack_graph(get_workload("bert_base", device=dev).pad_to(300))
    return ops.pack_graph(lm_cell("qwen2.5-32b", "prefill_32k", device=dev))  # V = 707


def _popsim_designs(dev, P, gbuf_bw_scaled=False):
    """P designs scaling cell_read_latency 0.5x-2x; with ``gbuf_bw_scaled``,
    also the global buffer's bandwidth 0.01x-100x, so that on bert_base the
    bandwidth-EMA gate stays open, shuts, or opens and shuts within one walk."""
    from repro_torch.core import ArchParams, TechParams, specialize
    from repro_torch.kernels import ops
    from repro_torch.kernels import popsim_kernel as pk

    tech = TechParams.default(dev)
    tech.cell_read_latency = tech.cell_read_latency * torch.linspace(0.5, 2.0, P, device=dev)[:, None]
    cp = ops.pack_chw(specialize(tech, ArchParams.default(dev))).clone()
    if gbuf_bw_scaled:
        gbuf = pk.BW.start + pk._GBUF
        cp[:, gbuf] = cp[:, gbuf] * torch.logspace(-2, 2, P, device=dev)
    return cp


@pytest.mark.parametrize("P", [1, 100, 1024, 65536])
@pytest.mark.parametrize("graph", ["bert_base-300", "qwen2.5-32b-prefill_32k"])
def test_popsim_kernel_matches_plain(cuda, graph, P):
    from repro_torch.kernels import ops, ref, runtime

    cp = _popsim_designs(cuda, P)
    gp = _popsim_graph(graph, cuda)
    before = runtime.LAUNCHES["popsim"]
    got = ops.popsim(gp, cp)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["popsim"] == before + 1
    _popsim_exact(got, ref.popsim_reference(gp, cp))


@pytest.mark.parametrize("lanes", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("V", [1, 37, 300])  # 37: a multiple of no lane count; 300: two tiles
def test_popsim_lanes_match_plain(cuda, V, lanes):
    from repro_torch.kernels import popsim_kernel as pk
    from repro_torch.kernels import ref

    gp = _popsim_graph("bert_base-300", cuda)[:V]
    cp = _popsim_designs(cuda, 97, gbuf_bw_scaled=True)
    _popsim_exact(pk.popsim_lanes(gp, cp, lanes), ref.popsim_reference(gp, cp))


def _edge(name, gp, cp):
    from repro_torch.kernels import popsim_kernel as pk

    gp, cp = gp.clone(), cp.clone()
    nan = float("nan")
    if name == "nan-in-one-design":  # one column of one design each
        for p, col in enumerate((pk.FREQ, pk.CAP_GBUF, pk.BW.start + 1, pk.RATE.start, pk.RATE.start + 2,
                                 pk.SYS_X, pk.SYS_Y, pk.E_FLOP.start, pk.RLAT.start + 2)):
            cp[3 * p + 1, col] = nan
    elif name == "rate-zero":  # every class at the 1e-9 floor, and one class at a time
        cp[0::2, pk.RATE] = 0.0
        for k in range(4):
            cp[4 * k + 1, pk.RATE.start + k] = 0.0
    elif name == "gbuf-bw-0.01x-100x":
        gbuf = pk.BW.start + pk._GBUF
        cp[:, gbuf] = cp[:, gbuf] * torch.logspace(-2, 2, cp.shape[0], device=cp.device)
    elif name == "signed-zeros":  # -0 and +0 into the max/min of the design and graph terms
        cp[0::2, pk.RLAT] = -0.0
        cp[1::2, pk.WLAT] = -0.0
        cp[0::3, pk.E_FLOP] = -0.0
        cp[0::4, pk.RATE.start + 1] = -0.0
        gp[0::5, pk.G_COMP] = -0.0
        gp[1::7, pk.G_DIMS] = -0.0
        gp[2::3, pk.G_READ] = -0.0
        gp[3::4, pk.G_ALLOC_GBUF] = -0.0
    elif name == "zero-divisors":  # 0/0 and x/0 where a design has a zero bandwidth, capacity or rate
        for p, col in enumerate((pk.BW.start, pk.BW.start + 1, pk.BW.start + 2, pk.CAP_GBUF, pk.FREQ, pk.SYS_X)):
            cp[2 * p + 1, col] = 0.0
        cp[20, pk.BW] = -0.0
    elif name == "nan-in-the-graph":
        gp[10, pk.G_COMP.start + 1] = nan
        gp[20, pk.G_DIMS.start + 2] = nan
    return gp, cp


@pytest.mark.parametrize("lanes", [0, 2, 8])  # 0: the launcher's choice, 32 lanes at 64 designs
@pytest.mark.parametrize("edge", ["nan-in-one-design", "rate-zero", "gbuf-bw-0.01x-100x", "signed-zeros",
                                  "zero-divisors", "nan-in-the-graph"])
def test_popsim_kernel_edges(cuda, edge, lanes):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import popsim_kernel as pk

    gp, cp = _edge(edge, _popsim_graph("bert_base-300", cuda), _popsim_designs(cuda, 64))
    got = ops.popsim(gp, cp) if lanes == 0 else pk.popsim_lanes(gp, cp, lanes)
    _popsim_exact(got, ref.popsim_reference(gp, cp))


def test_popsim_lanes_rejects_before_launch(cuda):
    from repro_torch.kernels import popsim_kernel as pk
    from repro_torch.kernels import runtime

    gp, cp = _popsim_graph("bert_base-300", cuda), _popsim_designs(cuda, 8)
    before = dict(runtime.LAUNCHES)
    for bad in (0, 1, 3, 64):
        with pytest.raises(ValueError):
            pk.popsim_lanes(gp, cp, bad)
    with pytest.raises(ValueError):
        pk.popsim_lanes(gp.cpu(), cp.cpu(), 2)
    assert runtime.LAUNCHES == before


# ---------------------------------------------------------------------------
# the model kernels: attention, the SSD scan, the selective scan
# ---------------------------------------------------------------------------

# float32: the reference's own tolerances (tests/test_kernels.py); the kernels
# sum in another order than the plain versions, so a relative term covers
# outputs of larger magnitude.  bfloat16 outputs are rounded from float32 in
# both, so they may differ by a bf16 step: 2e-2, the reference's bf16 bound.
_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# attention is also held row by row, relative to each row's norm: the
# elementwise bf16 bound is large beside a row that averages many keys
_ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_rows_close(got, want, dtype):
    rel = (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
    assert float(rel.max()) <= _ROW_RTOL[dtype], f"a row off by {float(rel.max())} of its norm"

ATTN_SHAPES = [
    # B, Hq, Hkv, Sq, Skv, D
    (1, 1, 1, 64, 64, 64),       # one tile: a single K/V tile and a single wgmma row block
    (1, 4, 4, 128, 128, 64),     # MHA
    (2, 8, 2, 256, 256, 64),     # GQA 4:1
    (1, 8, 1, 128, 128, 32),     # MQA
    (2, 4, 4, 64, 256, 64),      # suffix window, Sq < Skv
    (1, 32, 32, 257, 257, 64),   # zamba2's shared block at a ragged prompt
    (1, 8, 2, 100, 333, 64),     # ragged, GQA
    (2, 4, 2, 70, 50, 16),       # Sq > Skv: early rows see no key
    (1, 4, 2, 300, 200, 64),     # Sq > Skv at D = 64: whole q tiles of rows that see no key
    (2, 8, 2, 1, 300, 64),       # Sq = 1
]
# head width 128: the tensor-core kernel in bf16, the float32-pipe kernel in float32
ATTN_SHAPES_128 = [
    (1, 4, 4, 256, 256, 128),    # MHA
    (2, 8, 2, 200, 200, 128),    # GQA 4:1, ragged
    (1, 8, 2, 100, 333, 128),    # ragged, Sq < Skv
    (1, 4, 1, 300, 200, 128),    # Sq > Skv: early rows see no key
    (2, 8, 2, 1, 129, 128),      # Sq = 1
]
# kimi-k2's head width 112: the tensor-core kernel in bf16 (two 64-column TMA
# boxes a row, the second's columns 112-127 zero-filled past the row; P V as
# m64n112k16), the float32-pipe kernel in float32
ATTN_SHAPES_112 = [
    (1, 1, 1, 64, 64, 112),      # one tile: one K/V tile, one wgmma row block
    (1, 16, 2, 256, 256, 112),   # GQA 8:1, kimi-k2's group
    (1, 8, 1, 100, 333, 112),    # ragged, Sq < Skv
    (1, 8, 1, 300, 200, 112),    # Sq > Skv: early rows see no key
    (2, 16, 2, 1, 300, 112),     # Sq = 1
]
# the other head widths: inside and at each of the float32-pipe kernel's width
# caps (64, 128, 256), and widths that are not a multiple of 4 or 8 (its copies
# element by element); D 112 in bf16 goes to the tensor-core kernel
ATTN_SHAPES_WIDE = [
    (1, 4, 4, 200, 200, 48),
    (2, 8, 2, 100, 333, 112),    # kimi-k2's head width, GQA 4:1, Sq < Skv
    (1, 4, 2, 300, 200, 112),    # Sq > Skv
    (1, 2, 2, 65, 97, 80),
    (1, 2, 2, 64, 64, 96),
    (1, 4, 4, 129, 129, 256),
    (1, 8, 2, 70, 50, 256),      # Sq > Skv, GQA
    (1, 2, 2, 64, 70, 200),
    (1, 2, 1, 33, 33, 8),
    (1, 2, 2, 64, 70, 5),
]


def _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype, rows=True):
    """One call of the wrapper: the launch count of the kernel ``route`` names
    rises by one and no other attention count moves; the output is the plain
    version's within ``_TOL`` and, with ``rows``, row by row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator("cuda").manual_seed(Sq * 131 + Skv)
    q, k, v = (torch.randn(B, h, s, D, generator=gen, device=cuda).to(dtype)
               for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    names = ("flash_attention", "flash_attention_sm90")
    want_kernel = "flash_attention_sm90" if dtype == torch.bfloat16 and D in fa.SM90_HEAD_DIMS else "flash_attention"
    assert fa.route(dtype, D) == want_kernel
    before = {n: runtime.LAUNCHES[n] for n in names}
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert {n: runtime.LAUNCHES[n] - before[n] for n in names} == {n: int(n == want_kernel) for n in names}
    assert got.dtype == dtype
    want = ref.reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **_TOL[dtype])
    if rows:
        _assert_rows_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", ATTN_SHAPES_128)
def test_flash_attention_head_width_128_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", ATTN_SHAPES_112)
def test_flash_attention_head_width_112_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", ATTN_SHAPES_WIDE)
def test_flash_attention_other_head_widths_match_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype)


# the transformer families' serving shapes (bf16: the tensor-core kernel) and
# agreement shapes (float32): the vision model's cross-attention, not causal,
# q [B,32,Sq,128] against its 1,601 patches (a prime, so a ragged last K/V
# tile) in prefill and at Sq = 1 in every decode step of 2 slots;
# llama4-scout's GQA group 5 (40 query heads over 8); musicgen's MHA at D 64;
# kimi-k2's 64 query heads of 112 over 8
LM_ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal
    (1, 32, 8, 4096, 1601, 128, False),
    (1, 32, 8, 512, 1601, 128, False),
    (1, 32, 8, 67, 1601, 128, False),
    (2, 32, 8, 1, 1601, 128, False),
    (1, 40, 8, 1024, 1024, 128, True),
    (1, 40, 8, 67, 67, 128, True),
    (1, 32, 32, 1024, 1024, 64, True),
    (1, 32, 32, 67, 67, 64, True),
    (1, 64, 8, 1024, 1024, 112, True),
    (1, 64, 8, 67, 67, 112, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", LM_ATTN_CASES)
def test_flash_attention_transformer_family_shapes(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    _attention_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_width_1_matches_plain(cuda, causal, dtype):
    """At D = 1 a row is one output, so the row bound would be a relative bound
    on each output with no absolute floor, which the order of a float32 sum
    alone breaks where an output lies near 0; held to the elementwise bound."""
    _attention_case(cuda, 1, 2, 2, 50, 50, 1, causal, dtype, rows=False)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 112), (torch.bfloat16, 96)],
                         ids=["f32-64", "f32-112", "bf16-96"])
def test_flash_attention_reads_bases_off_a_16_byte_boundary(cuda, dtype, D):
    """The float32-pipe kernel copies 16 bytes at a time only from 16-byte
    aligned bases; from others it copies element by element."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(D + 1)
    q, k, v = (torch.randn(1 + 2 * 200 * D, generator=gen, device=cuda).to(dtype)[1:].view(1, 2, 200, D)
               for _ in range(3))
    assert q.data_ptr() % 16 != 0
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.reference_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **_TOL[dtype])
    _assert_rows_close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.float32, 128), (torch.bfloat16, 112)],
                         ids=["f32-64", "bf16-64", "bf16-128", "f32-128", "bf16-112"])
def test_flash_attention_takes_a_negative_scale(cuda, dtype, D, causal):
    """The tensor-core kernel takes the max of the raw scores where it folds the
    scale into the exponent, which holds only for a scale >= 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(D)
    q, k, v = (torch.randn(1, 4, 200, D, generator=gen, device=cuda).to(dtype) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=causal, scale=-0.5 * D ** -0.5)
    want = ref.reference_attention(q, k, v, causal=causal, scale=-0.5 * D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), **_TOL[dtype])
    _assert_rows_close(got, want, dtype)


def test_flash_attention_sm90_rejects_a_base_tma_cannot_read(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import runtime

    q = torch.zeros(1 + 2 * 64 * 64, device=cuda, dtype=torch.bfloat16)[1:].view(1, 2, 64, 64)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, q, q)
    assert runtime.LAUNCHES == before


def _ssd_inputs(gen, dev, B, S, H, P, N, dtype):
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev))
    Bm, Cm = (torch.randn(B, S, N, generator=gen, device=dev) for _ in range(2))
    return x, dt, A, Bm, Cm


def _check_ssd(y, state, args, dtype):
    """y and the final state against the per-step recurrence in float64: SSD's
    own tolerance (atol 1e-4, tests/test_kernels.py) with a relative term for
    large states; bf16 y within a bf16 step."""
    from repro_torch.kernels import ref

    y64, s64 = ref.ssd_reference(*args, dtype=torch.float64)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else _TOL[dtype]
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(state).all())
    torch.testing.assert_close(y.double(), y64, **tol)
    torch.testing.assert_close(state.double(), s64, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N", [(1, 64, 2, 16, 8), (2, 128, 4, 32, 16), (1, 32, 1, 64, 4),
                                       (1, 257, 4, 64, 64), (2, 1, 3, 16, 8), (1, 100, 2, 128, 128),
                                       (1, 1100, 64, 64, 64), (1, 300, 3, 100, 70), (2, 0, 2, 16, 8)])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, dtype):
    # S = 1, ragged S, many chunks at zamba2's width (4 heads a block), batch 2,
    # H = 1, N != P, N = P = 128, widths that are no multiple of 4, S = 0
    from repro_torch.kernels import runtime, ssd

    gen = torch.Generator("cuda").manual_seed(S * 7 + H)
    args = _ssd_inputs(gen, cuda, B, S, H, P, N, dtype)
    before = runtime.LAUNCHES["ssd_chunk_scan"]
    y, state = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["ssd_chunk_scan"] == before + 1
    _check_ssd(y, state, args, dtype)


@pytest.mark.parametrize("hpb", [1, 2, 4, 8])
def test_ssd_heads_per_block(cuda, monkeypatch, hpb):
    # 6 heads: the last group of 4 or 8 holds fewer heads than the block takes
    from repro_torch.kernels import ssd

    monkeypatch.setattr(ssd, "heads_per_block", lambda *a: hpb)
    args = _ssd_inputs(torch.Generator("cuda").manual_seed(hpb), cuda, 1, 200, 6, 64, 64, torch.float32)
    y, state = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    _check_ssd(y, state, args, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [300.0, 1e-2], ids=["decay-underflow", "long-memory"])
def test_ssd_decay_extremes(cuda, scale, dtype):
    # |A| dt in the hundreds: exp(cum) underflows to 0 within a step or two (and
    # exp(cum_i - cum_j) above the diagonal would overflow); |A| small: the state
    # carried over many chunks dominates y
    from repro_torch.kernels import ssd

    x, dt, A, Bm, Cm = _ssd_inputs(torch.Generator("cuda").manual_seed(17), cuda, 1, 600, 4, 64, 64, dtype)
    args = (x, dt, A * scale, Bm, Cm)
    y, state = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    _check_ssd(y, state, args, dtype)


@pytest.mark.parametrize("S,P,N", [(64, 64, 64), (300, 64, 64), (1000, 32, 128)])
def test_ssd_entering_states_match_plain_pass(cuda, monkeypatch, S, P, N):
    # the state entering each chunk, as the kernels' pass leaves it in their
    # scratch, against the plain version's pass
    from repro_torch.kernels import ref, ssd

    scratch = []
    alloc = ssd.scratch_for
    monkeypatch.setattr(ssd, "scratch_for", lambda *a: scratch.append(alloc(*a)) or scratch[-1])
    args = _ssd_inputs(torch.Generator("cuda").manual_seed(S + N), cuda, 1, S, 8, P, N, torch.float32)
    y, state = ssd.ssd_chunk_scan(*args)
    torch.cuda.synchronize()
    _, _, want = ref.ssd_scan_phases(*args, chunk=ssd.CHUNK)
    got = ssd.chunk_states(scratch[0], 1, S, 8, P, N)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    _check_ssd(y, state, args, torch.float32)


@pytest.mark.parametrize("P,N", [(129, 64), (64, 129), (0, 64)])
def test_ssd_rejects_unsupported_width_before_launch(cuda, P, N):
    from repro_torch.kernels import runtime, ssd

    args = _ssd_inputs(torch.Generator("cuda").manual_seed(0), cuda, 1, 70, 2, P, N, torch.float32)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="must lie in"):
        ssd.ssd_chunk_scan(*args)
    assert runtime.LAUNCHES == before


def _scan_inputs(gen, dev, B, S, C, N, dtype):
    u = torch.randn(B, S, C, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, C, generator=gen, device=dev))
    A = -torch.exp(torch.randn(C, N, generator=gen, device=dev))
    Bm, Cm = (torch.randn(B, S, N, generator=gen, device=dev) for _ in range(2))
    D = torch.randn(C, generator=gen, device=dev)
    return u, dt, A, Bm, Cm, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,C,N", [(1, 32, 16, 8), (2, 64, 32, 16), (1, 128, 8, 4), (1, 257, 8192, 16),
                                     (2, 1, 100, 16), (1, 77, 130, 3)])
def test_selective_scan_kernel_matches_plain(cuda, B, S, C, N, dtype):
    from repro_torch.kernels import ref, runtime, sscan

    gen = torch.Generator("cuda").manual_seed(S * 11 + C)
    args = _scan_inputs(gen, cuda, B, S, C, N, dtype)
    before = runtime.LAUNCHES["selective_scan"]
    y, state = sscan.selective_scan(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["selective_scan"] == before + 1
    y_ref, s_ref = ref.selective_scan(*args)
    # the selective scan's own tolerance (atol 2e-4, tests/test_kernels.py)
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32 else _TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=1e-4)


def _scan_edge_inputs(gen, dev, case, dtype):
    """Inputs at the selective-scan kernel's edges: 48-step chunks of 32
    channels, tiles by TMA when C % 8 == 0 and N == 16 (else element by
    element)."""
    B, S, C, N = SCAN_EDGES[case]
    u, dt, A, Bm, Cm, D = _scan_inputs(gen, dev, B, S, C, N, dtype)
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    if case == "long memory":  # the carry through all 86 chunks decides y and the state
        dt, A = 0.01 * rand(B, S, C), -1e-3 * (1 - rand(C, N))
    elif case == "fast decay":  # dt A <= -80: the decay underflows to 0
        dt, A = 80 + 20 * rand(B, S, C), -(1 + rand(C, N))
    return u, dt, A, Bm, Cm, D


SCAN_EDGES = {  # B, S, C, N
    "S 1": (1, 1, 64, 16),
    "S 49, one step past a chunk": (1, 49, 64, 16),
    "S 97, ragged at the second chunk": (2, 97, 64, 16),
    "S 8193, many carries": (1, 8193, 64, 16),
    "C 130": (1, 100, 130, 16),
    "C 100, N 3, batch 2": (2, 100, 100, 3),
    "N 3": (1, 60, 64, 3),
    "N 16, batch 2": (2, 77, 256, 16),
    "long memory": (1, 4096, 256, 16),
    "fast decay": (1, 300, 256, 16),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SCAN_EDGES))
def test_selective_scan_kernel_edges(cuda, case, dtype):
    """Against the plain version and the float64 recurrence, each with the
    selective scan's own tolerance (atol 2e-4, tests/test_kernels.py; a bf16
    step in bf16)."""
    from repro_torch.kernels import ref, runtime, sscan

    gen = torch.Generator("cuda").manual_seed(sum(SCAN_EDGES[case]))
    args = _scan_edge_inputs(gen, cuda, case, dtype)
    before = runtime.LAUNCHES["selective_scan"]
    y, state = sscan.selective_scan(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["selective_scan"] == before + 1
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(state).all())
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32 else _TOL[dtype]
    y_ref, s_ref = ref.selective_scan(*args)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=1e-4)
    y64, s64 = ref.selective_scan_reference(*args, dtype=torch.float64)
    torch.testing.assert_close(y.double(), y64, **tol)
    torch.testing.assert_close(state.double(), s64, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_kernel_takes_unaligned_bases(cuda, dtype):
    """A base off 16 bytes (TMA refuses it) goes element by element."""
    from repro_torch.kernels import ref, sscan

    gen = torch.Generator("cuda").manual_seed(11)
    u, dt, A, Bm, Cm, D = _scan_inputs(gen, cuda, 1, 70, 64, 16, dtype)
    u = torch.cat([u.new_zeros(1), u.flatten()])[1:].view(u.shape)
    assert u.data_ptr() % 16 != 0
    y, state = sscan.selective_scan(u, dt, A, Bm, Cm, D)
    y_ref, s_ref = ref.selective_scan(u, dt, A, Bm, Cm, D)
    tol = dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32 else _TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(state, s_ref, atol=2e-4, rtol=1e-4)



# --------------------------------------------------------------------------- #
# the scans' backwards (plain PyTorch from the kernels' entering states) on the
# card, against the same functions on the CPU; tolerances as
# tests/test_torch_ssm_grad.py's: atol 2e-4 (K5) / 1e-4 (K4) plus rtol 1e-4
# of each gradient's largest entry (a bf16 gradient: 2e-2 plus 1e-2 of it, as
# a bf16 step is 2^-8 of the value)
# --------------------------------------------------------------------------- #


def _grads_on(fn, args, cots, dev):
    xs = [a.detach().to(dev).requires_grad_(a.is_floating_point()) for a in args]
    y, state = fn(*xs)
    return [g.cpu() for g in torch.autograd.grad([y, state], xs, [c.to(dev) for c in cots])]


def _hold_grads(got, want, atol):
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        tol = (atol + 1e-4 * float(w.float().abs().max()) if g.dtype == torch.float32
               else 2e-2 + 1e-2 * float(w.float().abs().max()))
        assert float((g.double() - w.double()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["S 1", "S 97, ragged at the second chunk", "C 100, N 3, batch 2", "N 16, batch 2",
                                  "long memory", "fast decay"])
def test_selective_scan_entering_states_match_plain(cuda, case, dtype):
    """The kernel's state entering each 48-step chunk against the plain
    version's at the same chunking; y and the final state bit for bit those
    of the launch that writes no entering states."""
    from repro_torch.kernels import ref, runtime, sscan

    gen = torch.Generator("cuda").manual_seed(sum(SCAN_EDGES[case]) + 1)
    args = _scan_edge_inputs(gen, cuda, case, dtype)
    before = runtime.LAUNCHES["selective_scan"]
    y, state, entering = sscan.selective_scan_states_op(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["selective_scan"] == before + 1
    _, _, want = ref.selective_scan_states(*args, chunk=sscan.CHUNK)
    assert entering.shape == want.shape
    torch.testing.assert_close(entering, want, atol=2e-4, rtol=1e-4)
    y0, s0 = sscan.selective_scan_op(*args)
    assert torch.equal(y, y0) and torch.equal(state, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,C,N", [(1, 4096, 512, 16), (2, 97, 64, 16), (1, 150, 130, 3), (1, 1, 64, 16)])
def test_selective_scan_backward_on_card_matches_cpu(cuda, B, S, C, N, dtype):
    from repro_torch.kernels import runtime, sscan

    gen = torch.Generator("cuda").manual_seed(B * S + C)
    args = _scan_inputs(gen, cuda, B, S, C, N, dtype)
    cots = (torch.randn(B, S, C, generator=gen, device=cuda).to(dtype), torch.randn(B, C, N, generator=gen, device=cuda))
    before = runtime.LAUNCHES["selective_scan"]
    got = _grads_on(sscan.selective_scan, args, cots, cuda)
    assert runtime.LAUNCHES["selective_scan"] == before + 1  # the backward launches nothing
    _hold_grads(got, _grads_on(sscan.selective_scan, args, cots, "cpu"), 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N", [(1, 4096, 64, 64, 64), (2, 257, 4, 32, 16), (1, 100, 3, 100, 70),
                                       (1, 1, 2, 16, 8)])
def test_ssd_backward_on_card_matches_cpu(cuda, B, S, H, P, N, dtype):
    from repro_torch.kernels import runtime, ssd

    gen = torch.Generator("cuda").manual_seed(B * S + H)
    args = _ssd_inputs(gen, cuda, B, S, H, P, N, dtype)
    cots = (torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype),
            torch.randn(B, H, N, P, generator=gen, device=cuda))
    before = runtime.LAUNCHES["ssd_chunk_scan"]
    got = _grads_on(ssd.ssd_chunk_scan, args, cots, cuda)
    assert runtime.LAUNCHES["ssd_chunk_scan"] == before + 1  # the backward launches nothing
    _hold_grads(got, _grads_on(ssd.ssd_chunk_scan, args, cots, "cpu"), 1e-4)

def test_flash_attention_runs_float32_at_head_width_128(cuda):
    _attention_case(cuda, 1, 2, 2, 8, 8, 128, True, torch.float32)


@pytest.mark.parametrize("D", [8, 96, 256])
def test_flash_attention_runs_bf16_head_widths_off_the_tensor_cores(cuda, D):
    _attention_case(cuda, 1, 2, 2, 8, 8, D, True, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_rejects_head_widths_past_256(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import runtime

    q = torch.zeros(1, 2, 8, 257, device=cuda, dtype=dtype)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(q, q, q)
    assert runtime.LAUNCHES == before


def test_empty_inputs_launch_nothing(cuda):
    from repro_torch.kernels import ops, runtime, sscan

    before = dict(runtime.LAUNCHES)
    assert sscan.affine_scan_op(torch.empty(3, 0, device=cuda), 0.8, False).shape == (3, 0)
    assert sscan.affine_scan_op(torch.empty(0, 5, device=cuda), 0.8, True).shape == (0, 5)
    out = ops.popsim(torch.zeros(4, 16, device=cuda), torch.empty(0, 27, device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (0, 8)
    assert runtime.LAUNCHES == before


def test_population_chunk_on_the_card_matches_the_cpu(cuda):
    # the DSE path's population step: 4 members seeded from two library archs,
    # mixed objectives, a binding area budget, 3 epochs; the mapper runs once
    # on [P, W, V] and K1 takes its P·W rows, one launch each way an epoch
    import numpy as np

    from repro_torch.core import Graph, popsim
    from repro_torch.kernels import runtime
    from repro_torch.workloads import get_workload

    def run(dev):
        (tech, arch), spec, _ = popsim.seed_population(4, ("base", "edge"), key=0, device=dev)
        mixes = (popsim.sample_objective_mixes(4, device=dev), np.full(4, 300.0), np.full(4, np.inf))
        gs = Graph.stack([get_workload(n, device=dev) for n in ("lstm", "bert_base")])  # V = 109: K1
        return popsim.population_chunk(popsim.init_population_state(tech, arch), mixes, gs, 0.1,
                                       np.linspace(0.5, 2.0, 3, dtype=np.float32), spec=spec)

    before = {n: runtime.LAUNCHES[n] for n in _carry_names()}
    state, hist = run(cuda)
    assert {n: runtime.LAUNCHES[n] - before[n] for n in _carry_names()} == {n: 3 for n in _carry_names()}
    want_state, want_hist = run("cpu")
    np.testing.assert_allclose(hist, want_hist, rtol=1e-5)
    # the parameters, as the reference's population tests hold them (not their
    # logs, which lie near 0 for parameters near 1)
    for got, want in zip(state[0].leaves() + state[1].leaves(), want_state[0].leaves() + want_state[1].leaves()):
        np.testing.assert_allclose(got.exp().cpu().numpy(), want.exp().numpy(), rtol=1e-5)


# chunked_attention's gradients: the forward is the attention kernel, the
# backward plain PyTorch over block pairs; on the card against the same call
# on the CPU (whose forward is the plain version), at the training path's
# head widths (bf16 D 64 and 128 on the tensor cores, float32 on the float32
# pipes), causal, and the vision model's cross-attention over its 1,601
# patches (prime: K/V padded to 2,048 in the backward and masked)
TRAIN_ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal
    (1, 8, 2, 1024, 1024, 128, True),
    (2, 8, 8, 512, 512, 64, True),
    (1, 8, 2, 256, 1601, 128, False),
]
_GRAD_TOL = {torch.float32: dict(atol=5e-4, rtol=0.0), torch.bfloat16: dict(atol=2e-2, rtol=5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", TRAIN_ATTN_CASES)
def test_chunked_attention_grads_on_the_card_match_the_cpu(cuda, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import runtime
    from repro_torch.models.layers import chunked_attention

    gen = torch.Generator().manual_seed(Sq + Skv + D)
    base = [torch.randn(B, h, s, D, generator=gen) for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv), (Hq, Sq))]
    outs = {}
    for dev in ("cpu", cuda):
        q, k, v = (x.to(dev, dtype).detach().clone().requires_grad_(True) for x in base[:3])
        before = dict(runtime.LAUNCHES)
        out = chunked_attention(q, k, v, causal=causal)
        out.backward(base[3].to(dev, dtype))
        torch.cuda.synchronize()
        moved = {n: runtime.LAUNCHES[n] - before[n] for n in ("flash_attention", "flash_attention_sm90")}
        want = {n: int(dev != "cpu" and n == fa.route(dtype, D)) for n in moved}
        assert moved == want, (dev, moved)  # one forward launch on the card, none in the backward
        outs[str(dev)] = [t.detach().float().cpu() for t in (out, q.grad, k.grad, v.grad)]
    for name, got, ref in zip(("out", "dq", "dk", "dv"), outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, ref, **_GRAD_TOL[dtype], msg=lambda m: f"{name}: {m}")
