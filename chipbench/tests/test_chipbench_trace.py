"""The traced window's arithmetic and the per-layer readers, on a made-up
Chrome trace."""
from __future__ import annotations

import importlib.util

import pytest

from chipbench.harness import roofline
from chipbench.harness.trace import WINDOW_SPAN, Trace, parse
from chipbench.tests.conftest import ROOT


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    X("user_annotation", WINDOW_SPAN, 0, 1000),
    X("user_annotation", "chipbench::population_chunk", 10, 400),
    X("cpu_op", "aten::mul", 20, 30),
    X("cuda_runtime", "cudaLaunchKernel", 25, 5, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 300, 5, correlation=2),
    X("cuda_runtime", "cudaLaunchKernel", 600, 5, correlation=3),  # the client's, outside any call
    X("cpu_op", "aten::randn", 590, 100),
    X("kernel", "void carries_kernel<true>(float const*)", 100, 100, correlation=1),
    X("kernel", "void carries_backward_kernel(float const*)", 350, 50, correlation=2),
    X("kernel", "void randn_kernel()", 650, 50, correlation=3),
    X("gpu_memcpy", "Memcpy DtoH", 150, 100),
]


def test_parse_busy_idle_and_the_programs_kernels():
    out = parse(EVENTS)
    assert out["window_s"] == pytest.approx(1e-3)
    # busy: [100, 250] + [350, 400] + [650, 700] = 250 us
    assert out["busy_s"] == pytest.approx(250e-6)
    assert [k[0] for k in out["kernels"]] == ["void carries_kernel<true>(float const*)",
                                              "void carries_backward_kernel(float const*)"]
    # idle [0, 100] (the host in aten::mul), [250, 350] (in a launch), [400, 650] and [700, 1000]
    # (between calls: at their midpoints the host ran no traced event)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == {"python": pytest.approx(550e-6), "aten::mul": pytest.approx(100e-6),
                    "cudaLaunchKernel": pytest.approx(100e-6)}
    assert out["breakdown"]["device_ops"][0] == ["carries_kernel<true>(float const*)", pytest.approx(1e-4)]


def read(name, trace):
    spec = importlib.util.spec_from_file_location(name, ROOT / "chipbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def test_readers():
    out = parse(EVENTS)
    t = Trace(kernels=out["kernels"], window_s=out["window_s"], busy_s=out["busy_s"], work={"epochs": 2},
              shapes={"k1": (1000, 256)}, breakdown=out["breakdown"])
    assert read("kernels_per_epoch.descent", t) == 1.0
    assert read("device_idle.descent", t) == pytest.approx(0.75)
    least = roofline.least_seconds(*roofline.k1_forward(1000, 256)) + roofline.least_seconds(
        *roofline.k1_backward(1000, 256))
    assert read("k1_roofline.descent", t) == pytest.approx(100 * least / 150e-6)
    assert read("k1_roofline.sweep", t) == pytest.approx(100 * roofline.least_seconds(
        *roofline.k1_forward(1000, 256)) / 100e-6)
    assert read("kernels_per_request.sweep", t) is None  # no requests in a descent's trace
    empty = Trace(kernels=[], window_s=1.0, busy_s=0.0, work={"requests": 3}, shapes={"k1": (1, 1)}, breakdown={})
    for name in ("kernels_per_request.sweep", "k1_roofline.sweep", "device_idle.sweep"):
        assert read(name, empty) is None


def test_k1_bytes_from_its_shape():
    assert roofline.k1_forward(81920, 1024) == (17 * 81920 * 1024 + 4 * 81920, 7 * 81920 * 1024)
    assert roofline.k1_backward(81920, 1024) == (13 * 81920 * 1024 + 4 * 81920, 9 * 81920 * 1024)
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
