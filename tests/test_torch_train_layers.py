"""The port's attention gradients and bf16 products against the reference on
the CPU.

``chunked_attention``'s forward is the attention op (its plain version on the
CPU) and its backward a flash-style pass over the reference's static block
pairs; both are held against ``jax.grad`` of the reference's
``chunked_attention`` on the same numpy inputs: causal and full, GQA,
Sq != Skv, and a prime Skv (K/V padded and masked, as the vision model's
1,601 patches).  Tolerances: float32 atol 5e-4 (tests/test_kernels.py's
gradient check), bf16 atol 2e-2 + rtol 5e-2.

One case is held against autograd of the plain attention instead: a causal
call with a prime Skv > 128.  The reference pads K/V there before it takes
the causal offset ``Skv - Sq``, so its mask moves by the padding; the port's
forward (the kernel) and backward both keep the unpadded offset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import layers as jax_layers
from repro_torch.kernels import ref as port_ref
from repro_torch.models import layers as port_layers

TOL = {"float32": dict(atol=5e-4, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=5e-2)}

# name: (B, Hq, Hkv, Sq, Skv, D, causal, block_q, block_k)
CASES = {
    "causal-gqa": (2, 4, 2, 64, 64, 16, True, 16, 16),
    "causal-window": (1, 4, 2, 32, 64, 16, True, 16, 32),  # Sq < Skv: a suffix window
    "full-mha": (1, 2, 2, 48, 24, 8, False, 16, 8),  # Sq > Skv
    "full-prime-kv": (1, 4, 1, 32, 131, 16, False, 16, 64),  # 131 is prime: padded to 192 and masked
    "causal-one-block": (1, 2, 1, 24, 24, 32, True, 512, 512),
}


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, Sq, Skv, D = shape
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]


def _port_grads(q, k, v, do, dtype, **kw):
    ts = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True) for x in (q, k, v)]
    out = port_layers.chunked_attention(*ts, **kw)
    out.backward(torch.from_numpy(do).to(out.dtype))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_grads_match_reference(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, bq, bk = CASES[case]
    q, k, v, do = _draw((B, Hq, Hkv, Sq, Skv, D), seed=len(case) * 31 + Skv)

    def f(q, k, v):
        o = jax_layers.chunked_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        return jnp.sum(o.astype(jnp.float32) * do)

    jargs = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    want = jax.grad(f, (0, 1, 2))(*jargs)
    out, got = _port_grads(q, k, v, do, dtype, causal=causal, block_q=bq, block_k=bk)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, Hq, Sq, D)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL[dtype], err_msg=f"d{name}")


@pytest.mark.parametrize("Skv", [131, 257])
def test_causal_prime_kv_matches_plain_attention_autograd(Skv):
    """The padded path under a causal mask, against autograd of the dense
    plain attention (the unpadded offset, as the forward kernel masks)."""
    q, k, v, do = _draw((1, 4, 2, Skv, Skv, 16), seed=Skv)
    _, got = _port_grads(q, k, v, do, "float32", causal=True, block_q=64, block_k=64)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    port_ref.reference_attention(*ts, causal=True).backward(torch.from_numpy(do))
    for name, g, t in zip("qkv", got, ts):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=5e-5, rtol=0, err_msg=f"d{name}")


def test_forward_is_the_attention_op_and_no_grad_is_unchanged():
    """The forward's value is exactly the attention op's, with and without
    gradients (serving runs under no_grad through the same op)."""
    q, k, v, _ = _draw((2, 4, 2, 40, 40, 16), seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = port_ref.reference_attention(tq, tk, tv, causal=True)
    with torch.no_grad():
        assert torch.equal(port_layers.chunked_attention(tq, tk, tv, causal=True), want)
    got = port_layers.chunked_attention(tq.requires_grad_(True), tk, tv, causal=True)
    assert torch.equal(got.detach(), want) and got.grad_fn is not None


class _Largest(TorchDispatchMode):
    """The largest tensor any op makes while active, and the ops' names."""

    def __init__(self):
        super().__init__()
        self.numel, self.ops = 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(str(func))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_backward_never_builds_full_score_matrix_nor_calls_the_plain_attention(monkeypatch):
    B, Hq, Hkv, S, D = 1, 4, 2, 256, 8
    q, k, v, do = _draw((B, Hq, Hkv, S, S, D), seed=9)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port_layers.chunked_attention(*ts, causal=True, block_q=64, block_k=64)

    def refuse(*a, **k):
        raise AssertionError("the backward called the plain attention")

    monkeypatch.setattr(port_ref, "reference_attention", refuse)
    with _Largest() as seen:
        out.backward(torch.from_numpy(do))
    assert seen.numel < B * Hq * S * S, seen.numel  # a pair's scores: B*Hq*64*64
    assert not any("flash_attention" in op for op in seen.ops), seen.ops


def test_runs_group_the_reference_pairs():
    pairs = port_layers._causal_pairs(4, 4, 16, 16, True)
    assert pairs == [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2), (3, 3)]
    assert port_layers._spans(pairs, 8) == [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 0, 4)]
    assert port_layers._spans(pairs, 2) == [(0, 0, 1), (1, 0, 2), (2, 0, 2), (2, 2, 3), (3, 0, 2), (3, 2, 4)]
    assert port_layers._spans(pairs, 1) == [(qi, kj, kj + 1) for qi, kj in pairs]


@pytest.mark.parametrize("case", ["causal-gqa", "full-prime-kv"])
def test_pair_by_pair_equals_row_runs(case, monkeypatch):
    """With room for one block pair's scores only, the backward walks the
    pair list one pair at a time, as the reference's scan does: the same
    gradients as runs of a whole row."""
    B, Hq, Hkv, Sq, Skv, D, causal, bq, bk = CASES[case]
    q, k, v, do = _draw((B, Hq, Hkv, Sq, Skv, D), seed=3)
    _, whole = _port_grads(q, k, v, do, "float32", causal=causal, block_q=bq, block_k=bk)
    monkeypatch.setattr(port_layers, "_SLAB", B * Hq * bq * bk)
    _, pairwise = _port_grads(q, k, v, do, "float32", causal=causal, block_q=bq, block_k=bk)
    for name, a, b in zip("qkv", whole, pairwise):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("subscripts,xs,ws", [
    ("bsd,dhk->bshk", (2, 8, 32), (32, 4, 16)),
    ("bshk,hkd->bsd", (2, 8, 4, 16), (4, 16, 32)),
    ("bsd,df->bsf", (2, 8, 32), (32, 48)),
])
def test_mm_grads_match_the_reference_vjp(subscripts, xs, ws):
    """``mm`` has no backward of its own: autograd of the bf16 einsum gives
    the reference's ``_mm_vjp`` (bf16 cotangent, fp32 accumulation)."""
    rng = np.random.default_rng(len(subscripts))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0])).astype(np.float32)
    out_shape = jax.eval_shape(lambda a, b: jnp.einsum(subscripts, a, b), x, w).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.float32)
    jout, vjp = jax.vjp(lambda a, b: jax_layers.mm(subscripts, a, b), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tout = port_layers.mm(subscripts, tx, tw)
    tout.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    for got, want in ((tout, jout), (tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL["bfloat16"])
