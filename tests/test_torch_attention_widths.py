"""Attention at every head width the reference takes.

The reference's flash attention tiles any head width D (its blocks are
``(block_q, D)``).  The port sends bf16 at D = 64, 112 and 128 to its
tensor-core kernel, and float32 at every width from 1 to 256 and bf16 at every
other one to its float32-pipe kernel (compiled at width caps 64, 128 and 256).  On the CPU the
op runs its plain version; these tests hold that, on numpy inputs from a seed,
against the reference's Pallas kernel (interpret mode, blocks that tile S) and
its jnp oracle at the widths between and past the caps, with the reference's
tolerances (tests/test_kernels.py: atol 2e-5 in float32, 2e-2 in bf16).  The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import runtime


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_route_sends_every_head_width_to_a_kernel(dtype):
    for D in range(1, fa.MAX_HEAD_DIM + 1):
        want = "flash_attention_sm90" if dtype == torch.bfloat16 and D in (64, 112, 128) else "flash_attention"
        assert fa.route(dtype, D) == want, D
    assert {"flash_attention", "flash_attention_sm90"} <= set(runtime.SOURCES) & set(runtime.LAUNCHES)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 257), (torch.bfloat16, 257), (torch.float64, 64)],
                         ids=["f32-257", "bf16-257", "f64-64"])
def test_route_raises_past_the_widest_kernel_and_for_other_types(dtype, D):
    with pytest.raises(ValueError, match="head width"):
        fa.route(dtype, D)


# B, Hq, Hkv, Sq, Skv: GQA 2:1 with Sq = Skv, and MHA with Sq < Skv (a suffix
# window); blocks of 32 tile both
SHAPES = {"gqa": (1, 4, 2, 64, 64), "window": (1, 2, 2, 32, 96)}


def _check_widths(shape: str, D: int, causal: bool, dtype: str, atol: float):
    B, Hq, Hkv, Sq, Skv = SHAPES[shape]
    rng = np.random.default_rng(D * 1009 + Sq * 7 + Skv + causal)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s, np.float32), dtype)
                                    for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Hq, Sq, D)
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32)
    oracle = jax_ref.reference_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=atol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=atol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [8, 48, 80, 112, 128, 256])
def test_float32_head_widths_match_the_reference(D, causal):
    _check_widths("gqa", D, causal, "float32", 2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_head_width_112_matches_the_reference(causal):
    _check_widths("gqa", 112, causal, "bfloat16", 2e-2)


@pytest.mark.parametrize("D", [112, 256])
def test_float32_suffix_window_matches_the_reference(D):
    _check_widths("window", D, True, "float32", 2e-5)
