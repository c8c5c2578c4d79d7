"""The scans' backwards on the CPU: the gradients of the port's K5
(``sscan.selective_scan``) and K4 (``ssd.ssd_chunk_scan``) through their
autograd formulas (``ref.selective_scan_bwd``, ``ref.ssd_scan_bwd``, from the
state entering each chunk that the forward keeps), against ``jax.grad`` of the
reference's scans (``repro.models.mamba.selective_scan`` and ``ssd_scan``) at
S a multiple of the reference's chunk, and against autograd of the port's
float64 per-step oracles (``ref.selective_scan_reference``,
``ref.ssd_reference``) at S ragged against the port's chunks.  float32, with
nonzero cotangents of y and of the final state.

Tolerance: atol 2e-4 (K5) / 1e-4 (K4), the reference's kernel tolerances,
plus rtol 1e-4 of each gradient's largest entry.

``jax.grad`` of the reference's chunked ``ssd_scan`` is NaN once a chunk's
log-decay, the sum of dt A over the chunk, falls below ~-88: its
``jnp.where(mask, exp(li), 0)`` takes exp of the entries above the diagonal
too, and their zero cotangent meets inf.  So K4 is held to it at decays where
its gradient is defined, and at zamba2's decays (A down to -64) to the
gradient of the reference's own per-step oracle,
``repro.kernels.ref.ssd_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import mamba as jax_mamba
from repro_torch.kernels import ref, ssd, sscan


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def scan_inputs(B, S, C, N, seed):
    """Mamba1 inputs from numpy: u, dt (after softplus), A (negative), B, C, D,
    and the cotangents of y and of the final state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ins = (f(B, S, C), _softplus(f(B, S, C) - 1.0), -np.exp(f(C, N)), f(B, S, N), f(B, S, N), f(C))
    return ins, (f(B, S, C), f(B, C, N))


def ssd_inputs(B, S, H, P, N, seed, dt_shift=-2.0, log_a=0.5):
    """Mamba2 inputs from numpy: x, dt (after softplus), A (negative), B, C,
    and the cotangents of y and of the final state.  ``dt_shift`` and
    ``log_a`` scale the decays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ins = (f(B, S, H, P), _softplus(f(B, S, H) + dt_shift), -np.exp(log_a * f(H)).astype(np.float32),
           f(B, S, N), f(B, S, N))
    return ins, (f(B, S, H, P), f(B, H, N, P))


def port_grads(fn, ins, cots, use_state=True):
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y, state = fn(*xs)
    outs, gos = [y], [torch.from_numpy(cots[0])]
    if use_state:
        outs.append(state)
        gos.append(torch.from_numpy(cots[1]))
    return [g.numpy() for g in torch.autograd.grad(outs, xs, gos)]


def jax_grads(fn, ins, cots, use_state=True):
    y, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in ins))
    g_state = jnp.asarray(cots[1]) if use_state else jnp.zeros_like(y[1])
    return [np.asarray(g) for g in vjp((jnp.asarray(cots[0]), g_state))]


def torch64_grads(fn, ins, cots):
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in ins]
    y, state = fn(*xs, dtype=torch.float64)
    return [g.numpy() for g in torch.autograd.grad([y, state], xs, [torch.from_numpy(c).double() for c in cots])]


def assert_grads_close(got, want, names, atol):
    for name, g, w in zip(names, got, want):
        assert np.all(np.isfinite(w)), f"{name}: the reference's gradient is not finite"
        tol = atol + 1e-4 * float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        assert err <= tol, (name, err, tol)


K5_NAMES = ("u", "dt", "A", "B", "C", "D")
K4_NAMES = ("x", "dt", "A", "B", "C")


# --------------------------------------------------------------------------- #
# K5, the selective scan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("use_state", [True, False], ids=["y+state", "y"])
@pytest.mark.parametrize("B,S,C,N", [(2, 192, 24, 16), (1, 128, 40, 8), (2, 64, 8, 1)])
def test_selective_scan_grads_match_jax_grad(B, S, C, N, use_state):
    ins, cots = scan_inputs(B, S, C, N, seed=S + C)
    got = port_grads(sscan.selective_scan, ins, cots, use_state)
    want = jax_grads(lambda *a: jax_mamba.selective_scan(*a, chunk=64), ins, cots, use_state)
    assert_grads_close(got, want, K5_NAMES, 2e-4)


@pytest.mark.parametrize("S", [1, 47, 49, 100, 151])
def test_selective_scan_grads_ragged_match_float64_recurrence(S):
    ins, cots = scan_inputs(2, S, 12, 5, seed=S)
    got = port_grads(sscan.selective_scan, ins, cots)
    assert_grads_close(got, torch64_grads(ref.selective_scan_reference, ins, cots), K5_NAMES, 2e-4)


@pytest.mark.parametrize("S", [1, 48, 100, 145])
def test_selective_scan_entering_states_equal_the_recurrence(S):
    """The plain op's state entering each 48-step chunk is the per-step
    recurrence's state after the steps before it (0 first)."""
    (u, dt, A, Bm, Cm, D), _ = scan_inputs(2, S, 12, 5, seed=S + 1)
    t = [torch.from_numpy(x) for x in (u, dt, A, Bm, Cm, D)]
    y, state, entering = sscan.selective_scan_states_op(*t)
    nc = -(-S // sscan.CHUNK)
    assert entering.shape == (2, nc, 12, 5) and entering.dtype == torch.float32
    assert float(entering[:, 0].abs().max()) == 0.0
    for c in range(1, nc):
        cut = [x[:, :c * sscan.CHUNK] if x.ndim == 3 else x for x in t]
        _, want = ref.selective_scan_reference(*cut, dtype=torch.float64)
        np.testing.assert_allclose(entering[:, c].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    y0, s0 = sscan.selective_scan_op(*t)
    _, s64 = ref.selective_scan_reference(*t, dtype=torch.float64)
    np.testing.assert_allclose(state.numpy(), s64.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=2e-4, rtol=1e-4)


def test_selective_scan_bf16_input_gets_a_bf16_gradient():
    ins, cots = scan_inputs(1, 96, 16, 16, seed=3)
    u = torch.from_numpy(ins[0]).bfloat16().requires_grad_(True)
    rest = [torch.from_numpy(x).requires_grad_(True) for x in ins[1:]]
    y, _ = sscan.selective_scan(u, *rest)
    assert y.dtype == torch.bfloat16
    gu, gdt = torch.autograd.grad(y.float().sum(), [u, rest[0]])
    assert gu.dtype == torch.bfloat16 and gdt.dtype == torch.float32
    assert bool(torch.isfinite(gu.float()).all()) and bool(torch.isfinite(gdt).all())


def test_selective_scan_bf16_grads_are_the_float32_ones_cast():
    """On the CPU the bf16 scan computes in float32: its gradients on bf16 u
    and a bf16 cotangent equal, bit for bit, the float32 scan's on the same
    values, with gu cast to bf16 (chip_smoke.py's backward check runs the
    costly CPU side once for both dtypes on that ground)."""
    ins, cots = scan_inputs(1, 150, 16, 16, seed=9)
    u16, gy16 = torch.from_numpy(ins[0]).bfloat16(), torch.from_numpy(cots[0]).bfloat16()
    rest, gs = [torch.from_numpy(x) for x in ins[1:]], torch.from_numpy(cots[1])

    def grads(u, gy):
        xs = [u.clone().requires_grad_(True)] + [x.clone().requires_grad_(True) for x in rest]
        y, state = sscan.selective_scan(*xs)
        return torch.autograd.grad([y, state], xs, [gy, gs])

    got, want = grads(u16, gy16), grads(u16.float(), gy16.float())
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want[0].bfloat16())
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))


# --------------------------------------------------------------------------- #
# K4, the SSD scan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("use_state", [True, False], ids=["y+state", "y"])
@pytest.mark.parametrize("B,S,H,P,N", [(2, 128, 4, 8, 16), (1, 192, 3, 16, 8), (1, 64, 2, 64, 64)])
def test_ssd_grads_match_jax_grad(B, S, H, P, N, use_state):
    """At decays whose chunk log-decay stays above -88, where the
    reference's chunked gradient is defined."""
    ins, cots = ssd_inputs(B, S, H, P, N, seed=S + H)
    assert float((ins[1].reshape(B, -1, 64, H).sum(2) * ins[2]).min()) > -60
    got = port_grads(ssd.ssd_chunk_scan, ins, cots, use_state)
    want = jax_grads(lambda *a: jax_mamba.ssd_scan(*a, chunk=64), ins, cots, use_state)
    assert_grads_close(got, want, K4_NAMES, 1e-4)


def test_ssd_grads_at_zamba2_decays_match_the_reference_oracle():
    """zamba2's A runs from -1 to -64 (here -1 to -16) with dt near softplus
    of its bias: the chunks' log-decays pass -88, the reference's chunked
    gradient is NaN there, and the port is held to ``jax.grad`` of the
    reference's per-step recurrence instead."""
    ins, cots = ssd_inputs(2, 128, 16, 8, 16, seed=7, dt_shift=0.0)
    ins = ins[:2] + (-np.arange(1, 17, dtype=np.float32),) + ins[3:]
    assert float((ins[1].reshape(2, -1, 64, 16).sum(2) * ins[2]).min()) < -88
    got = port_grads(ssd.ssd_chunk_scan, ins, cots)
    assert_grads_close(got, jax_grads(jax_ref.ssd_reference, ins, cots), K4_NAMES, 1e-4)


@pytest.mark.parametrize("S", [1, 63, 65, 100, 150])
def test_ssd_grads_ragged_match_float64_recurrence(S):
    ins, cots = ssd_inputs(2, S, 3, 4, 5, seed=S, dt_shift=0.0)
    got = port_grads(ssd.ssd_chunk_scan, ins, cots)
    assert_grads_close(got, torch64_grads(ref.ssd_reference, ins, cots), K4_NAMES, 1e-4)


# --------------------------------------------------------------------------- #
# what the ops do with and without gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("which", ["selective_scan", "ssd_chunk_scan"])
def test_no_grad_keeps_no_states(which, monkeypatch):
    """Under ``torch.no_grad()`` (serving) the wrapper calls the forward op
    alone; with gradients on it calls the op that keeps the entering states,
    once a call."""
    mod, fn = (sscan, sscan.selective_scan) if which == "selective_scan" else (ssd, ssd.ssd_chunk_scan)
    ins = scan_inputs(1, 50, 8, 4, 0)[0] if which == "selective_scan" else ssd_inputs(1, 70, 2, 4, 3, 0)[0]
    calls = []
    real = getattr(mod, f"{which}_states_op")
    monkeypatch.setattr(mod, f"{which}_states_op", lambda *a: calls.append(1) or real(*a))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    with torch.no_grad():
        y, _ = fn(*xs)
    assert y.grad_fn is None and not calls
    y, _ = fn(*(x.detach() for x in xs))  # no input requires grad
    assert y.grad_fn is None and not calls
    y, _ = fn(*xs)
    assert y.grad_fn is not None and len(calls) == 1


@pytest.mark.parametrize("which", ["selective_scan", "ssd_chunk_scan"])
def test_backward_runs_in_its_profiler_range(which):
    from torch.profiler import ProfilerActivity, profile

    mod, fn = (sscan, sscan.selective_scan) if which == "selective_scan" else (ssd, ssd.ssd_chunk_scan)
    ins = scan_inputs(1, 50, 8, 4, 0)[0] if which == "selective_scan" else ssd_inputs(1, 70, 2, 4, 3, 0)[0]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y, _ = fn(*xs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y.sum().backward()
    assert mod.BACKWARD_RANGE in {e.key for e in prof.key_averages()}
    assert mod.BACKWARD_RANGE == f"repro_torch::{which}_backward"


def test_states_ops_launch_the_kernels_on_cuda():
    """The ops that keep the entering states take the kernel on CUDA tensors
    (the forward op's CUDA implementation, which launches it) and the plain
    version on CPU tensors, as the forward ops do (tests/test_torch_slice.py)."""
    import inspect

    for op, impl, launcher in (("repro_torch::selective_scan_states", sscan._selective_scan_states_cuda,
                                "_selective_scan_cuda("),
                               ("repro_torch::ssd_chunk_scan_states", ssd._ssd_chunk_scan_states_cuda,
                                "_ssd_chunk_scan_cuda(")):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
        src = inspect.getsource(impl)
        assert launcher in src and "except" not in src and "ref." not in src
    for launcher in (sscan._selective_scan_cuda, ssd._ssd_chunk_scan_cuda):
        assert "count_launch" in inspect.getsource(launcher)
