"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip (the CPU suite holds
the plain versions against the reference package instead).  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
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


@pytest.mark.parametrize("P", [1, 100, 1024])
def test_popsim_kernel_matches_plain(cuda, P):
    from repro_torch.core import ArchParams, TechParams, specialize
    from repro_torch.kernels import ops, ref, runtime
    from repro_torch.workloads import get_workload

    tech = TechParams.default(cuda)
    tech.cell_read_latency = tech.cell_read_latency * torch.linspace(0.5, 2.0, P, device=cuda)[:, None]
    cp = ops.pack_chw(specialize(tech, ArchParams.default(cuda)))
    gp = ops.pack_graph(get_workload("bert_base", device=cuda).pad_to(300))  # spans two graph tiles
    before = runtime.LAUNCHES["popsim"]
    got = ops.popsim(gp, cp)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["popsim"] == before + 1
    torch.testing.assert_close(got, ref.popsim_reference(gp, cp), rtol=1e-5, atol=1e-3)


def test_empty_inputs_launch_nothing(cuda):
    from repro_torch.kernels import ops, runtime, sscan

    before = dict(runtime.LAUNCHES)
    assert sscan.affine_scan_op(torch.empty(3, 0, device=cuda), 0.8, False).shape == (3, 0)
    assert sscan.affine_scan_op(torch.empty(0, 5, device=cuda), 0.8, True).shape == (0, 5)
    out = ops.popsim(torch.zeros(4, 16, device=cuda), torch.empty(0, 27, device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (0, 8)
    assert runtime.LAUNCHES == before
