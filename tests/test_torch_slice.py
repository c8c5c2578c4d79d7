"""The port's slice as a whole, and the rules the port keeps.

  * optimize() over [bert_base, granite-3-8b:train_4k] in both packages;
  * no repro_torch module (nor chip_smoke.py) imports JAX or the reference;
  * without a GPU, an entry point called with no ``device`` raises instead
    of running on the CPU;
  * chip_smoke.py prints no result and exits non-zero off the card.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core.dopt as jdopt
import repro.workloads as jwl
import repro_torch.core.dopt as tdopt
import repro_torch.workloads as twl

ROOT = pathlib.Path(__file__).resolve().parents[1]
HIST_KEYS = ("objective", "runtime", "energy", "area", "edp", "fault")


@pytest.fixture(scope="module")
def slice_runs():
    cells = [("bert_base", None), ("granite-3-8b", "train_4k")]

    def graphs(wl):
        return [wl.get_workload(n, **({"device": "cpu"} if wl is twl else {})) if s is None
                else wl.lm_cell(n, s, **({"device": "cpu"} if wl is twl else {})) for n, s in cells]

    return (tdopt.optimize(graphs(twl), steps=4, device="cpu"), jdopt.optimize(graphs(jwl), steps=4))


class TestSliceEndToEnd:
    def test_history_matches_reference(self, slice_runs):
        got, want = slice_runs
        for k in HIST_KEYS:
            np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, err_msg=k)
        assert got.history["objective"][-1] < got.history["objective"][0]

    def test_final_params_match_reference(self, slice_runs):
        got, want = slice_runs
        for t, j in ((got.tech, want.tech), (got.arch, want.arch)):
            for f in dataclasses.fields(j):
                np.testing.assert_allclose(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)),
                                           rtol=1e-4, err_msg=f.name)


def _run(code: str, cwd=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=cwd or ROOT,
                          env=env, timeout=300)


class TestRules:
    def test_port_imports_no_jax_and_no_reference(self):
        code = (
            "import importlib, json, pkgutil, sys\n"
            "import repro_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "sys.path.insert(0, '.'); import chip_smoke\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))"
            " or k == 'repro' or k.startswith('repro.'))\n"
            "print(json.dumps({'mods': mods, 'bad': bad}))\n"
        )
        out = _run(code)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["bad"] == []
        for m in ("repro_torch.core.mapper", "repro_torch.core.dopt", "repro_torch.kernels.sscan",
                  "repro_torch.kernels.popsim_kernel", "repro_torch.workloads.dfg_lm",
                  "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd", "repro_torch.models.model",
                  "repro_torch.serving.engine"):
            assert m in res["mods"]

    def test_entry_points_need_a_device_without_cuda(self):
        from repro_torch.core import ArchParams, Graph, TechParams, optimize
        from repro_torch.kernels import runtime

        calls = [TechParams.default, ArchParams.default, lambda: TechParams.bounds(),
                 lambda: twl.get_workload("lstm"), lambda: twl.lm_cell("granite-3-8b", "train_4k"),
                 lambda: Graph.from_numpy({f: np.zeros((1, 3)) for f in ("n_comp", "n_read", "n_write",
                                                                         "n_alloc", "dims", "op_kind",
                                                                         "edges")}),
                 lambda: optimize(twl.get_workload("lstm", device="cpu"), steps=1)]
        if torch.cuda.is_available():
            assert runtime.default_device().type == "cuda"
            return
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()

    def test_cuda_tensors_never_take_the_plain_version(self):
        # each kernel is a torch op whose CUDA implementation launches the
        # kernel and whose CPU implementation is the plain version: the
        # dispatcher picks by the tensor's device, and nothing catches a fault
        import inspect

        from repro_torch.kernels import flash_attention, popsim_kernel, ssd, sscan

        for op, cuda_impl in (("repro_torch::affine_scan", sscan._affine_scan_cuda),
                              ("repro_torch::popsim", popsim_kernel._popsim_cuda),
                              ("repro_torch::flash_attention", flash_attention._flash_attention_cuda),
                              ("repro_torch::ssd_chunk_scan", ssd._ssd_chunk_scan_cuda),
                              ("repro_torch::selective_scan", sscan._selective_scan_cuda)):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, "CPU")
            src = inspect.getsource(cuda_impl)
            assert "count_launch" in src and "except" not in src and "reference" not in src
        x = torch.rand(2, 5)
        torch.testing.assert_close(torch.ops.repro_torch.affine_scan(x, 0.8, False),
                                   sscan.affine_scan_reference(0.8, x))

    def test_chip_smoke_fails_off_the_card(self, tmp_path):
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
                             timeout=300)
        if not torch.cuda.is_available():
            assert out.returncode != 0
            assert '"ok"' not in out.stdout
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        alone = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, cwd=tmp_path,
                               timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert alone.returncode != 0
        assert '"ok"' not in alone.stdout

    def test_kernel_sources_ship(self):
        from repro_torch.kernels import runtime

        for src in runtime.SOURCES.values():
            text = (runtime.CSRC / src).read_text()
            assert 'extern "C"' in text and "cudaGetLastError" in text
        assert '"repro_torch.kernels" = ["csrc/*"]' in (ROOT / "pyproject.toml").read_text()
