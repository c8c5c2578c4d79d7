"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

affine_scan     — K1: the mapper's two Alg.-7 carries (buffer occupancy and
                  bandwidth EMA) in one launch forward and one backward
                  (``sscan.mapper_carries``), and the bare affine scan
                  (``csrc/affine_scan.cu``)
mapper          — the mapper's carry-free stages around K1 on the no-gradient
                  path, intrinsics and gates-and-reductions
                  (``mapper_kernel.py``, ``csrc/mapper.cu``)
popsim          — DSim population evaluation (``csrc/popsim.cu``)
flash_attention — GQA attention with an online softmax (``flash_attention.py``,
                  ``csrc/flash_attention.cu``)
ssd_chunk_scan  — the Mamba2 chunked SSD scan (``ssd.py``, ``csrc/ssd.cu``)
selective_scan  — the Mamba1 selective scan (``sscan.py``, ``csrc/selective_scan.cu``)

Each kernel has a plain PyTorch version in ref.py.  A wrapper launches its
kernel on CUDA tensors (raising if the build or the launch fails) and runs
the plain version on CPU tensors.  runtime.py builds and loads the kernels
and counts their launches.

The wrappers are imported lazily: core.params imports runtime, and ops
imports core, so an eager import here would be circular.
"""
from __future__ import annotations

_OPS = ("affine_scan", "pack_chw", "pack_graph", "popsim")
__all__ = ["runtime", *_OPS]


def __getattr__(name: str):
    import importlib

    if name in _OPS:
        value = getattr(importlib.import_module("repro_torch.kernels.ops"), name)
    elif name == "runtime":
        value = importlib.import_module("repro_torch.kernels.runtime")
    else:
        raise AttributeError(f"module 'repro_torch.kernels' has no attribute {name!r}")
    globals()[name] = value
    return value
