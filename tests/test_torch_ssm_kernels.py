"""The port's model kernels on the CPU against the reference package.

On CPU tensors each op (``repro_torch::flash_attention``, ``::ssd_chunk_scan``,
``::selective_scan``) runs its plain version; these tests hold that against
the reference's Pallas kernel (interpret mode) and its jnp oracles, on the
same numpy inputs.  Tolerances are the reference's own
(tests/test_kernels.py): attention atol 2e-5 in f32 and 2e-2 in bf16, SSD
atol 1e-4, selective scan atol 2e-4.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import ref as jax_ref
from repro.kernels import ssd_chunk_scan as jax_ssd
from repro.kernels.sscan import selective_scan_pallas
from repro.models import mamba as jax_mamba
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, ssd, sscan


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor (bf16 rounding is
    round-to-nearest-even in both)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


ATTN_SHAPES = [
    # B, Hq, Hkv, Sq, Skv, D, block_q, block_k (the reference kernel's blocks
    # must tile the sequence; the port's kernel masks ragged tiles itself)
    (1, 4, 4, 128, 128, 64, 64, 64),    # MHA
    (2, 8, 2, 256, 256, 64, 128, 128),  # GQA 4:1
    (1, 8, 1, 128, 128, 32, 64, 64),    # MQA
    (2, 4, 4, 64, 256, 64, 64, 64),     # suffix window, Sq < Skv
    (1, 4, 2, 67, 67, 16, 67, 67),      # ragged (prime) S
    (1, 8, 2, 33, 99, 32, 33, 33),      # ragged, GQA, Sq < Skv
]


class TestAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,bq,bk", ATTN_SHAPES)
    def test_matches_reference_kernel_and_oracle(self, B, Hq, Hkv, Sq, Skv, D, bq, bk, causal):
        rng = np.random.default_rng(Sq * 7 + Skv)
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s, np.float32), "float32")
                                        for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
        got = fa.flash_attention(tq, tk, tv, causal=causal)
        kernel = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
        oracle = jax_ref.reference_attention(jq, jk, jv, causal=causal)
        np.testing.assert_allclose(_np(got), _np(kernel), atol=2e-5)
        np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-5)

    @pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-5)])
    @pytest.mark.parametrize("Sq,Skv", [(128, 128), (67, 67), (33, 99)])
    def test_dtypes(self, dtype, tol, Sq, Skv):
        rng = np.random.default_rng(Sq)
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s, np.float32), dtype)
                                        for s in ((1, 4, Sq, 64), (1, 2, Skv, 64), (1, 2, Skv, 64)))
        got = fa.flash_attention(tq, tk, tv, causal=True)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), _np(jax_ref.reference_attention(jq, jk, jv, causal=True)), atol=tol)

    def test_op_is_the_plain_version_on_cpu(self):
        q, k, v = torch.randn(1, 4, 9, 16), torch.randn(1, 2, 12, 16), torch.randn(1, 2, 12, 16)
        torch.testing.assert_close(torch.ops.repro_torch.flash_attention(q, k, v, True, 0.25),
                                   ref.reference_attention(q, k, v, causal=True, scale=0.25), rtol=0, atol=0)

    def test_rejects_what_the_kernel_does_not_take(self):
        q = torch.randn(1, 4, 8, 16)
        with pytest.raises(TypeError):
            fa.flash_attention(q.double(), q.double(), q.double())
        with pytest.raises(ValueError):
            fa.flash_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))  # 4 heads onto 3

    # which kernel the op launches on the card is a function of dtype and head
    # width alone: bf16 at 64, 112 or 128 on the tensor cores, every other width up
    # to 256 on the float32 pipes (float32 there keeps the reference's 2e-5: no TF32)
    @pytest.mark.parametrize("dtype,D,kernel", [
        (torch.bfloat16, 64, "flash_attention_sm90"), (torch.bfloat16, 128, "flash_attention_sm90"),
        (torch.bfloat16, 112, "flash_attention_sm90"), (torch.float32, 112, "flash_attention"),
        (torch.bfloat16, 16, "flash_attention"), (torch.bfloat16, 32, "flash_attention"),
        (torch.float32, 16, "flash_attention"), (torch.float32, 32, "flash_attention"),
        (torch.float32, 64, "flash_attention")])
    def test_route_is_a_function_of_dtype_and_head_width(self, dtype, D, kernel):
        from repro_torch.kernels import runtime

        assert fa.route(dtype, D) == kernel
        assert kernel in runtime.SOURCES and kernel in runtime.LAUNCHES

    @pytest.mark.parametrize("dtype,D", [(torch.float32, 257), (torch.bfloat16, 257), (torch.bfloat16, 512),
                                         (torch.float32, 0), (torch.float16, 64)])
    def test_route_raises_where_no_kernel_is_built(self, dtype, D):
        with pytest.raises(ValueError, match="head width"):
            fa.route(dtype, D)

    def test_head_width_128_in_bf16_matches_reference(self):
        # the plain version behind the op at the sm90 kernel's wider head
        rng = np.random.default_rng(128)
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s, np.float32), "bfloat16")
                                        for s in ((1, 4, 40, 128), (1, 2, 40, 128), (1, 2, 40, 128)))
        got = fa.flash_attention(tq, tk, tv, causal=True)
        np.testing.assert_allclose(_np(got), _np(jax_ref.reference_attention(jq, jk, jv, causal=True)), atol=2e-2)


def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)  # softplus
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), np.float32)
    C = rng.standard_normal((B, S, N), np.float32)
    return x, dt, A, Bm, C


class TestSSD:
    @pytest.mark.parametrize("B,S,H,P,N,chunk", [
        (1, 64, 2, 16, 8, 16),
        (2, 128, 4, 32, 16, 32),
        (1, 32, 1, 64, 4, 8),
        (1, 67, 3, 16, 8, 67),   # ragged for the port's 64-step chunks
        (1, 200, 2, 16, 8, 40),  # four chunks of the port's 64 steps, the last one ragged
    ])
    def test_matches_reference(self, B, S, H, P, N, chunk):
        args = _ssd_inputs(np.random.default_rng(S + H), B, S, H, P, N)
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(a) for a in args]
        y, state = ssd.ssd_chunk_scan(*targs)
        for name, (y_ref, s_ref) in {
            "kernel": jax_ssd(*jargs, chunk=chunk),
            "chunked jnp": jax_mamba.ssd_scan(*jargs, chunk=chunk),
            "per-step oracle": jax_ref.ssd_reference(*jargs),
        }.items():
            np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-4, err_msg=name)
            np.testing.assert_allclose(_np(state), _np(s_ref), atol=1e-4, err_msg=name)
        y2, s2 = ref.ssd_reference(*targs)  # the port's own per-step oracle
        np.testing.assert_allclose(_np(y2), _np(y), atol=1e-4)
        np.testing.assert_allclose(_np(s2), _np(state), atol=1e-4)

    @pytest.mark.parametrize("chunk", [1, 7, 64])
    def test_any_chunk_is_exact(self, chunk):
        targs = [torch.from_numpy(a) for a in _ssd_inputs(np.random.default_rng(3), 2, 45, 2, 8, 4)]
        y, state = ref.ssd_scan(*targs, chunk=chunk)
        y_ref, s_ref = ref.ssd_reference(*targs)
        torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
        torch.testing.assert_close(state, s_ref, atol=1e-4, rtol=0)

    @pytest.mark.parametrize("B,S,H,P,N", [(1, 64, 2, 16, 8), (1, 67, 3, 16, 8)])
    def test_float64_oracle_matches_reference(self, B, S, H, P, N):
        args = _ssd_inputs(np.random.default_rng(S + H), B, S, H, P, N)
        y_ref, s_ref = jax_ref.ssd_reference(*map(jnp.asarray, args))
        y, state = ref.ssd_reference(*(torch.from_numpy(a) for a in args), dtype=torch.float64)
        assert y.dtype == state.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=1e-4)
        np.testing.assert_allclose(state.numpy(), _np(s_ref), atol=1e-4)

    def test_long_memory_carries_the_state_across_chunks(self):
        # |A| small: exp(dt A) ~ 0.99 a step, so each y is mostly the state carried
        # over several 64-step chunks; held to the JAX kernel (64-step chunks), the
        # JAX oracle and the float64 recurrence
        x, dt, A, Bm, C = _ssd_inputs(np.random.default_rng(11), 1, 320, 2, 16, 8)
        A = (A * 1e-2).astype(np.float32)
        targs = [torch.from_numpy(a) for a in (x, dt, A, Bm, C)]
        jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, C)]
        y, state = ssd.ssd_chunk_scan(*targs)
        # the last chunk's own steps alone, from a zero state: what is left of y is carried
        last = [t[:, 256:] for t in targs[:2]] + [targs[2]] + [t[:, 256:] for t in targs[3:]]
        y_own, _ = ref.ssd_reference(*last, dtype=torch.float64)
        assert float((y[:, 256:].double() - y_own).norm()) > float(y_own.norm())
        y64, s64 = ref.ssd_reference(*targs, dtype=torch.float64)
        for name, (y_ref, s_ref) in {"kernel": jax_ssd(*jargs, chunk=64),
                                     "per-step oracle": jax_ref.ssd_reference(*jargs),
                                     "float64": (y64.numpy(), s64.numpy())}.items():
            np.testing.assert_allclose(_np(y), np.asarray(y_ref, np.float64), atol=1e-4, rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(_np(state), np.asarray(s_ref, np.float64), atol=1e-4, rtol=1e-4,
                                       err_msg=name)

    @pytest.mark.parametrize("S", [1, 64, 200])
    def test_pass_gives_the_state_entering_each_chunk(self, S):
        # the plain version's phase 2: the state entering chunk c is the
        # recurrence's state after the first 64 c steps
        targs = [torch.from_numpy(a) for a in _ssd_inputs(np.random.default_rng(S), 2, S, 3, 16, 8)]
        y, state, entering = ref.ssd_scan_phases(*targs, chunk=ssd.CHUNK)
        assert entering.shape == (2, -(-S // ssd.CHUNK), 3, 8, 16)
        for c in range(entering.shape[1]):
            _, s_ref = ref.ssd_reference(*(t[:, :c * ssd.CHUNK] for t in targs[:2]), targs[2],
                                         *(t[:, :c * ssd.CHUNK] for t in targs[3:]), dtype=torch.float64)
            torch.testing.assert_close(entering[:, c].double(), s_ref, atol=1e-4, rtol=1e-4)
        _, s_ref = ref.ssd_reference(*targs, dtype=torch.float64)
        torch.testing.assert_close(state.double(), s_ref, atol=1e-4, rtol=1e-4)

    def test_bf16_x_keeps_float32_state(self):
        x, dt, A, Bm, C = _ssd_inputs(np.random.default_rng(5), 1, 70, 2, 16, 8)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        y, state = ssd.ssd_chunk_scan(xb, *(torch.from_numpy(a) for a in (dt, A, Bm, C)))
        assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
        y_ref, s_ref = jax_ref.ssd_reference(jnp.asarray(x).astype("bfloat16"), *map(jnp.asarray, (dt, A, Bm, C)))
        np.testing.assert_allclose(_np(state), _np(s_ref), atol=1e-4)
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=2e-2, rtol=2e-2)  # one bf16 step of y

    def test_rejects_what_the_kernel_does_not_take(self):
        x, dt, A, Bm, C = (torch.from_numpy(a) for a in _ssd_inputs(np.random.default_rng(0), 1, 8, 2, 4, 4))
        with pytest.raises(TypeError):
            ssd.ssd_chunk_scan(x, dt.double(), A, Bm, C)
        with pytest.raises(ValueError):
            ssd.ssd_chunk_scan(x, dt[:, :4], A, Bm, C)


def _scan_inputs(rng, B, S, C, N):
    u = rng.standard_normal((B, S, C), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, C)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((C, N))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), np.float32)
    Cm = rng.standard_normal((B, S, N), np.float32)
    D = rng.standard_normal(C).astype(np.float32)
    return u, dt, A, Bm, Cm, D


SCAN_SHAPES = [
    # B, S, C, N, the reference kernel's chunk and channel block
    (1, 32, 16, 8, 8, 16),
    (2, 64, 32, 16, 16, 16),
    (1, 128, 8, 4, 32, 8),
    (1, 67, 24, 8, 67, 8),   # ragged for the port's 64-step chunks
]


class TestSelectiveScan:
    @pytest.mark.parametrize("B,S,C,N,chunk,bc", SCAN_SHAPES)
    def test_matches_reference(self, B, S, C, N, chunk, bc):
        args = _scan_inputs(np.random.default_rng(S + C), B, S, C, N)
        jargs = [jnp.asarray(a) for a in args]
        y, state = sscan.selective_scan(*(torch.from_numpy(a) for a in args))
        y_kernel = selective_scan_pallas(*jargs, chunk=chunk, block_c=bc)
        y_ref, s_ref = jax_mamba.selective_scan(*jargs, chunk=chunk)
        np.testing.assert_allclose(_np(y), _np(y_kernel), atol=2e-4)
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=2e-4)
        np.testing.assert_allclose(_np(state), _np(s_ref), atol=2e-4)

    def test_bf16_u(self):
        u, dt, A, Bm, Cm, D = _scan_inputs(np.random.default_rng(9), 1, 40, 12, 16)
        y, state = sscan.selective_scan(torch.from_numpy(u).to(torch.bfloat16),
                                        *(torch.from_numpy(a) for a in (dt, A, Bm, Cm, D)))
        assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
        y_ref, s_ref = jax_mamba.selective_scan(jnp.asarray(u).astype("bfloat16"),
                                                *map(jnp.asarray, (dt, A, Bm, Cm, D)), chunk=8)
        np.testing.assert_allclose(_np(state), _np(s_ref), atol=2e-4)
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=2e-2, rtol=2e-2)  # one bf16 step of y

    def test_rejects_what_the_kernel_does_not_take(self):
        u, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in _scan_inputs(np.random.default_rng(0), 1, 8, 4, 4))
        with pytest.raises(TypeError):
            sscan.selective_scan(u, dt, A, Bm, Cm, D.double())
        with pytest.raises(ValueError):
            sscan.selective_scan(u, dt, A[:2], Bm, Cm, D)

    @pytest.mark.parametrize("B,S,C,N,chunk,bc", SCAN_SHAPES)
    def test_per_step_oracle_matches_reference(self, B, S, C, N, chunk, bc):
        args = _scan_inputs(np.random.default_rng(S + C), B, S, C, N)
        y_ref, s_ref = jax_mamba.selective_scan(*map(jnp.asarray, args), chunk=chunk)
        targs = [torch.from_numpy(a) for a in args]
        for dtype in (torch.float32, torch.float64):
            y, state = ref.selective_scan_reference(*targs, dtype=dtype)
            assert y.dtype == state.dtype == dtype
            np.testing.assert_allclose(y.double().numpy(), _np(y_ref), atol=2e-4)
            np.testing.assert_allclose(state.double().numpy(), _np(s_ref), atol=2e-4)
