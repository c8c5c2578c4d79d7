"""Port conformance: the mapper's two Alg.-7 carries as one op (K1),
``repro_torch.kernels.sscan.mapper_carries``, in its plain version on the CPU.

Forward against the reference package's ``minaffine_prefix_assoc`` and
``affine_prefix_assoc`` with the exclusive shift, gradients against
``jax.grad`` of the same; a tie against autograd through the sequential
``torch.minimum`` recurrence; the mapper with ``MapperCfg(streaming=False)``,
where the occupancy carry decides cycles, against ``repro.core.mapper``.
Inputs come from numpy seeds.  Tolerances follow the reference's own tests
(tests/test_mapper_equiv.py): values rtol 1e-5, gradients rtol 1e-4 / atol
1e-6; per-vertex cycles get an absolute slack of the vertex's tiles (one
cycle a tile: a ceil may move on the last ulp).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dgen as jdgen
import repro.core.mapper as jmapper
import repro.core.params as jparams
import repro.workloads as jwl
import repro_torch.core.dgen as tdgen
import repro_torch.core.mapper as tmapper
import repro_torch.core.params as tparams
import repro_torch.workloads as twl
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sscan as tsscan

CPU = "cpu"
DECAYS = (tmapper._OCC_DECAY, tmapper._BW_DECAY, tmapper._BW_GAIN)
_GBUF = tmapper._GBUF


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _draw(seed: int, R: int, V: int, per_row_cap: bool):
    """alloc near cap (a steady state of 2*alloc clamps at alloc > cap/2), so
    rows clamp often; bandwidth utilizations in [0, 2], as the mapper clips."""
    rng = np.random.default_rng(seed)
    cap = rng.uniform(1.0, 3.0, R if per_row_cap else ()).astype(np.float32)
    alloc = (np.reshape(cap, (-1, 1)) * rng.uniform(0.2, 0.9, (R, V))).astype(np.float32)
    bw_x = rng.uniform(0.0, 2.0, (R, V)).astype(np.float32)
    w_occ, w_bw = rng.normal(size=(2, R, V)).astype(np.float32)
    return alloc, bw_x, cap, w_occ, w_bw


def _jax_carries(alloc, bw_x, cap):
    """The reference's carries, exclusive, one row at a time."""
    occ_decay, bw_decay, bw_gain = DECAYS

    def excl(after):
        return jnp.concatenate([jnp.zeros((1,), after.dtype), after[:-1]])

    def row(a, x, c):
        occ = excl(jmapper.minaffine_prefix_assoc(occ_decay, a, c))
        return occ, excl(jmapper.affine_prefix_assoc(bw_decay, bw_gain * x))

    cap_rows = jnp.broadcast_to(cap, alloc.shape[:1])
    return jax.vmap(row)(alloc, bw_x, cap_rows)


def _torch_grads(alloc, bw_x, cap, w_occ, w_bw, fn):
    ts = [torch.tensor(x, requires_grad=True) for x in (alloc, bw_x, cap)]
    occ, bw = fn(*ts)
    (occ * torch.tensor(w_occ) + bw * torch.tensor(w_bw)).sum().backward()
    return (occ.detach(), bw.detach()), [t.grad for t in ts]


def _sequential(alloc, bw_x, cap):
    """The recurrences one vertex at a time, as map_workload_scan runs them
    (torch.minimum each step), differentiable by autograd."""
    occ_decay, bw_decay, bw_gain = DECAYS
    s = t = torch.zeros(torch.broadcast_shapes(alloc.shape[:-1], bw_x.shape[:-1], cap.shape))
    occ, bw = [], []
    for j in range(alloc.shape[-1]):
        occ.append(s)
        bw.append(t)
        s = torch.minimum(occ_decay * s + alloc[..., j], cap)
        t = bw_decay * t + bw_gain * bw_x[..., j]
    return torch.stack(occ, -1), torch.stack(bw, -1)


class TestPlainVersion:
    @pytest.mark.parametrize("per_row_cap", [False, True], ids=["scalar_cap", "row_cap"])
    @pytest.mark.parametrize("R", [1, 5])
    @pytest.mark.parametrize("V", [1, 33, 707, 1024])
    def test_values_and_gradients_match_reference(self, V, R, per_row_cap):
        alloc, bw_x, cap, w_occ, w_bw = _draw(V * 10 + R, R, V, per_row_cap)
        want = _jax_carries(jnp.asarray(alloc), jnp.asarray(bw_x), jnp.asarray(cap))

        def jloss(a, x, c):
            occ, bw = _jax_carries(a, x, c)
            return jnp.sum(occ * w_occ) + jnp.sum(bw * w_bw)

        want_g = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(alloc), jnp.asarray(bw_x), jnp.asarray(cap))
        got, got_g = _torch_grads(alloc, bw_x, cap, w_occ, w_bw,
                                  lambda a, x, c: tsscan.mapper_carries(a, x, c, *DECAYS))
        for name, g, w in zip(("occ_prev", "bw_prev"), got, want):
            _close(g.numpy(), w, 1e-5, what=name)
        for name, g, w in zip(("alloc", "bw_x", "cap"), got_g, want_g):
            w = np.asarray(w)
            assert g.shape == w.shape
            _close(g.numpy(), w, 1e-4, atol=1e-6, what=f"grad {name}")

    def test_rows_clamp_and_codes_follow_the_recurrence(self):
        alloc, bw_x, cap, _, _ = _draw(7, 5, 707, True)
        occ_prev, _, code = tref.mapper_carries_reference(torch.tensor(alloc), torch.tensor(bw_x),
                                                          torch.tensor(cap), *DECAYS)
        assert code.dtype == torch.uint8
        want = np.zeros_like(alloc, np.uint8)
        for r in range(5):
            s = np.float32(0.0)
            for j in range(707):
                u = np.float32(np.float32(0.5) * s) + alloc[r, j]
                want[r, j] = 2 if u < cap[r] else (1 if u == cap[r] else 0)
                s = min(u, cap[r])
        np.testing.assert_array_equal(code.numpy(), want)
        clamped = float((code == 0).float().mean())
        assert 0.1 < clamped < 0.9  # the draw exercises both sides of the clamp
        _close(occ_prev.numpy(), _sequential(torch.tensor(alloc), torch.tensor(bw_x),
                                             torch.tensor(cap))[0].numpy(), 1e-5)

    def test_tie_splits_the_gradient_as_torch_minimum(self):
        # powers of two, so every u = 0.5*s + alloc that meets cap meets it exactly
        cap = torch.tensor([4.0])
        alloc = torch.tensor([[4.0, 2.0, 2.0, 1.0, 3.0, 2.0, 0.5, 8.0, 2.0]])
        bw_x = torch.tensor([[0.5, 1.0, 0.0, 2.0, 1.5, 0.25, 1.0, 0.5, 0.75]])
        rng = np.random.default_rng(11)
        w_occ, w_bw = rng.normal(size=(2, 1, 9)).astype(np.float32)
        args = (alloc.numpy(), bw_x.numpy(), cap.numpy(), w_occ, w_bw)
        got, got_g = _torch_grads(*args, lambda a, x, c: tsscan.mapper_carries(a, x, c, *DECAYS))
        want, want_g = _torch_grads(*args, _sequential)
        _, _, code = tref.mapper_carries_reference(alloc, bw_x, cap, *DECAYS)
        assert int((code == 1).sum()) >= 3  # ties at vertices 0, 1, 2 and 5
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        for g, w in zip(got_g, want_g):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)

    def test_broadcast_inputs_sum_gradients_back(self):
        # a [P, 1] population of designs over W stacked workloads: alloc [W, V]
        # (the graph's), bw_x [P, W, V], cap [P, 1]
        rng = np.random.default_rng(5)
        P, W, V = 3, 2, 40
        cap = rng.uniform(1.0, 3.0, (P, 1)).astype(np.float32)
        alloc = rng.uniform(0.3, 1.5, (W, V)).astype(np.float32)
        bw_x = rng.uniform(0.0, 2.0, (P, W, V)).astype(np.float32)
        w_occ, w_bw = rng.normal(size=(2, P, W, V)).astype(np.float32)
        got, got_g = _torch_grads(alloc, bw_x, cap, w_occ, w_bw,
                                  lambda a, x, c: tsscan.mapper_carries(a, x, c, *DECAYS))
        want, want_g = _torch_grads(alloc, bw_x, cap, w_occ, w_bw, _sequential)
        for g, w in zip(got, want):
            assert g.shape == (P, W, V)
            _close(g.numpy(), w.numpy(), 1e-5, atol=1e-6)
        for g, w, x in zip(got_g, want_g, (alloc, bw_x, cap)):
            assert g.shape == x.shape
            _close(g.numpy(), w.numpy(), 1e-4, atol=1e-6)

    def test_backward_reference_is_the_closed_form(self):
        alloc, bw_x, cap, w_occ, w_bw = _draw(3, 5, 64, True)
        _, _, code = tref.mapper_carries_reference(torch.tensor(alloc), torch.tensor(bw_x), torch.tensor(cap),
                                                   *DECAYS)
        ga, gb, gc = tref.mapper_carries_backward_reference(torch.tensor(w_occ), torch.tensor(w_bw), code, *DECAYS)
        m = code.numpy() * 0.5
        occ_decay, bw_decay, bw_gain = DECAYS
        lam = np.zeros_like(w_occ)
        mu = np.zeros_like(w_bw)
        for j in range(62, -1, -1):
            lam[:, j] = w_occ[:, j + 1] + occ_decay * m[:, j + 1] * lam[:, j + 1]
            mu[:, j] = w_bw[:, j + 1] + bw_decay * mu[:, j + 1]
        _close(ga.numpy(), m * lam, 1e-5, atol=1e-6)
        _close(gb.numpy(), bw_gain * mu, 1e-5, atol=1e-6)
        _close(gc.numpy(), ((1 - m) * lam).sum(-1), 1e-5, atol=1e-5)


class TestOp:
    def test_ops_are_registered_for_both_devices(self):
        # the CUDA implementation launches the kernel, the CPU one is the plain
        # version: the dispatcher picks by the tensor's device, nothing catches a fault
        for op, cuda_impl in (("repro_torch::mapper_carries", tsscan._mapper_carries_cuda),
                              ("repro_torch::mapper_carries_backward", tsscan._mapper_carries_backward_cuda)):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
            src = inspect.getsource(cuda_impl)
            assert "count_launch" in src and "except" not in src and "reference" not in src
        from repro_torch.kernels import runtime

        assert {"mapper_carries", "mapper_carries_backward", "affine_scan"} <= set(runtime.LAUNCHES)
        alloc, bw_x, cap, w_occ, w_bw = (torch.tensor(x) for x in _draw(2, 3, 17, True))
        got = torch.ops.repro_torch.mapper_carries(alloc, bw_x, cap, *DECAYS)
        want = tref.mapper_carries_reference(alloc, bw_x, cap, *DECAYS)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        ga, gb, gc = torch.ops.repro_torch.mapper_carries_backward(w_occ, w_bw, got[2], *DECAYS, False)
        assert ga.numel() == 0 and gb.shape == (3, 17) and gc.shape == (3,)

    def test_bad_inputs_raise(self):
        x = torch.rand(3, 8)
        with pytest.raises(TypeError):
            tsscan.mapper_carries(x.double(), x, torch.ones(3), *DECAYS)
        with pytest.raises(ValueError):
            tsscan.mapper_carries_op(x, torch.rand(2, 8), torch.ones(3), *DECAYS)
        with pytest.raises(ValueError):
            tsscan.mapper_carries(x, torch.rand(3, 9), torch.ones(3), *DECAYS)

    def test_empty_rows(self):
        occ, bw = tsscan.mapper_carries(torch.rand(3, 0), torch.rand(3, 0), torch.ones(3), *DECAYS)
        assert occ.shape == bw.shape == (3, 0)
        occ, bw = tsscan.mapper_carries(torch.rand(0, 4), torch.rand(0, 4), torch.ones(()), *DECAYS)
        assert occ.shape == bw.shape == (0, 4)

    def test_carry_prefixes_is_one_op_call_each_way(self, monkeypatch):
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = tsscan.mapper_carries_op, tsscan.mapper_carries_backward_op

        def count(key, fn):
            def wrapped(*a):
                calls[key] += 1
                return fn(*a)
            return wrapped

        monkeypatch.setattr(tsscan, "mapper_carries_op", count("fwd", fwd))
        monkeypatch.setattr(tsscan, "mapper_carries_backward_op", count("bwd", bwd))
        tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
        cap = tc.capacity.clone().requires_grad_(True)
        tc = dataclasses.replace(tc, capacity=cap)
        ms = tmapper.map_workload(tc, twl.get_workload("bert_base", device=CPU),
                                  tmapper.MapperCfg(scan_impl="assoc", streaming=False))
        ms.cycles.backward()
        assert calls == {"fwd": 1, "bwd": 1}
        assert cap.grad is not None and bool(torch.isfinite(cap.grad).all())


# --------------------------------------------------------------------------- #
# the mapper where the occupancy carry decides cycles
# --------------------------------------------------------------------------- #

NO_STREAM = ["resnet50", "bert_base"]


def _chw_pair():
    jc = jdgen.specialize(jparams.TechParams.default(), jparams.ArchParams.default())
    tc = tdgen.specialize(tparams.TechParams.default(CPU), tparams.ArchParams.default(CPU))
    return jc, tc


class TestMapperWithoutStreaming:
    @pytest.mark.parametrize("impl", ["auto", "assoc"])
    @pytest.mark.parametrize("name", NO_STREAM)
    def test_state_matches_reference(self, name, impl):
        jc, tc = _chw_pair()
        got = tmapper.map_workload(tc, twl.get_workload(name, device=CPU),
                                   tmapper.MapperCfg(streaming=False, scan_impl=impl))
        want = jmapper.map_workload(jc, jwl.get_workload(name), jmapper.MapperCfg(streaming=False, scan_impl=impl))
        for f in dataclasses.fields(want):
            _close(getattr(got, f.name).detach().numpy(), np.asarray(getattr(want, f.name)), 1e-5,
                   atol=1e-30, what=f"{name}/{impl}/{f.name}")

    @pytest.mark.parametrize("name", NO_STREAM)
    def test_breakdown_matches_reference(self, name):
        jc, tc = _chw_pair()
        cfg = dict(streaming=False)
        got = tmapper.map_workload_breakdown(tc, twl.get_workload(name, device=CPU), tmapper.MapperCfg(**cfg))
        want = jmapper.map_workload_breakdown(jc, jwl.get_workload(name), jmapper.MapperCfg(**cfg))
        tiles = np.asarray(want["tiles_v"], np.float64)
        slack = {"cycles_v": tiles, "time_v": tiles / float(np.asarray(jc.frequency))}
        for k in ("cycles_v", "time_v", "tiles_v", "t_comp_v", "t_main_exposed_v", "t_level", "active"):
            g, w = got[k].numpy().astype(np.float64), np.asarray(want[k], np.float64)
            err = np.abs(g - w) - (slack.get(k, 0.0) + 1e-5 * np.abs(w))
            assert g.shape == w.shape and float(err.max()) <= 0.0, f"{name}/{k}: off by {float(err.max())}"

    @pytest.mark.parametrize("name", NO_STREAM)
    def test_cycles_gradient_wrt_capacity_matches_reference(self, name):
        jc, tc = _chw_pair()
        cfg = dict(streaming=False, scan_impl="assoc")
        jg = jwl.get_workload(name)
        want = jax.grad(lambda c: jmapper.map_workload(dataclasses.replace(jc, capacity=c), jg,
                                                       jmapper.MapperCfg(**cfg)).cycles)(jc.capacity)
        cap = tc.capacity.clone().requires_grad_(True)
        ms = tmapper.map_workload(dataclasses.replace(tc, capacity=cap), twl.get_workload(name, device=CPU),
                                  tmapper.MapperCfg(**cfg))
        (got,) = torch.autograd.grad(ms.cycles, cap)
        want = np.asarray(want)
        assert float(np.abs(want[_GBUF])) > 0.0  # the carry's gradient reaches capacity
        _close(got.numpy(), want, 1e-4, atol=1e-6 * float(np.abs(want).max()))

    @pytest.mark.parametrize("name", NO_STREAM)
    def test_occupancy_decides_cycles(self, name, monkeypatch):
        # the check above is blind unless a wrong occupancy moves cycles: force it empty
        _, tc = _chw_pair()
        g = twl.get_workload(name, device=CPU)
        cfg = tmapper.MapperCfg(streaming=False, scan_impl="assoc")
        right = float(tmapper.map_workload(tc, g, cfg).cycles)
        carries = tmapper._carry_prefixes
        monkeypatch.setattr(tmapper, "_carry_prefixes",
                            lambda *a: (torch.zeros_like(carries(*a)[0]), carries(*a)[1]))
        assert float(tmapper.map_workload(tc, g, cfg).cycles) != right
