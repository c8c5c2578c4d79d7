"""Device selection, kernel build/load and launch accounting for the port.

This is the one module of ``repro_torch`` that compiles or loads CUDA code.

  * :func:`default_device` — the card; raises when no GPU is present, so an
    entry point called without ``device=`` never silently runs on the CPU.
  * :func:`resolve_device` — ``None`` → :func:`default_device`, else the
    caller's device; a CUDA device also pins float32 matmuls to full
    precision (TF32 off), the numerics the reference runs with.
  * :func:`library` — build (at first use) and load the shared library of
    one kernel source under ``csrc/``.  Every source is compiled by its own
    ``nvcc`` process, all started together, into ``build/repro_torch_ext/``
    at the repo root (``REPRO_TORCH_BUILD_DIR`` overrides it), keyed by a hash
    of the source, the torch version, the nvcc version and the flags.  The
    kernels expose a plain C interface and are bound with ``ctypes``: no
    PyTorch header is compiled, so a cold build takes seconds, not minutes.
    A build or launch failure raises; nothing falls back to a plain version.
  * :func:`executable_fingerprint` — the runtime a persisted program key is
    valid under (torch, CUDA, the card's arch and every kernel library's
    key), for the design service's program cache.
  * :data:`LAUNCHES` / :func:`reset_launches` — one count per kernel, bumped
    by its wrapper exactly where it launches the kernel.  ``affine_scan.cu``
    holds three kernels: the bare affine scan and the mapper's two carries,
    forward and backward, each counted under its own name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import instrument

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# kernel name -> source file under csrc/
SOURCES = {
    "affine_scan": "affine_scan.cu",
    "popsim": "popsim.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
    "ssd_chunk_scan": "ssd.cu",
    "selective_scan": "selective_scan.cu",
}
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "--shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-kernel additions.  The simulator's kernels are built with no contraction
# into FMAs (and no fast math anywhere): IEEE '/', ceilf and denormals behave
# as in the plain PyTorch versions they are held against, where a one-ulp move
# upstream of a ceil moves whole cycles.  The model kernels keep nvcc's default
# contraction: they are held against their plain versions with a tolerance.
EXTRA_FLAGS = {"affine_scan": ("--fmad=false",), "popsim": ("--fmad=false",)}


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

LAUNCHES: dict[str, int] = {name: 0 for name in (*SOURCES, "mapper_carries", "mapper_carries_backward")}
BUILD_LOG: dict[str, str] = {}  # kernel name -> nvcc/ptxas output of its build
BUILD_SECONDS: dict[str, float] = {}  # kernel name -> seconds from the builds' start to its end

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# its own lock, not _LOCK: a count must never wait behind a build
_COUNT_LOCK = threading.Lock()


# --------------------------------------------------------------------------- #
# devices
# --------------------------------------------------------------------------- #


def default_device() -> torch.device:
    """The card.  Raises when PyTorch sees no CUDA device: the port runs on
    the CPU only when the caller asks for it explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# --------------------------------------------------------------------------- #
# launch accounting
# --------------------------------------------------------------------------- #


def count_launch(name: str) -> None:
    """One launch of kernel ``name``.  Atomic: the pooled design service
    launches from several threads, and ``+=`` on a dict entry is a read
    and a write that another thread can interleave."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# build + load
# --------------------------------------------------------------------------- #


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout


def _target(name: str, nvcc_version: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name]).read_bytes())
    for part in (torch.__version__, nvcc_version, " ".join(flags(name))):
        h.update(part.encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


_FINGERPRINTS: dict[str, str] = {}


def executable_fingerprint(device=None) -> str:
    """The runtime identity a persisted program key is only valid under.

    The persistent program cache (:mod:`repro_torch.serving.aotcache`) folds
    this string into every record's digest, so a record written under
    another runtime misses cleanly instead of being rebuilt against it.  On
    the card it names the torch version, ``torch.version.cuda``, the card's
    compute capability and every kernel library as :func:`_target` keys it
    (a digest of the source, torch, ``nvcc`` and the flags): a record
    written under other kernel sources misses.  On the CPU it names torch
    and the device type, and runs no ``nvcc``.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"torch={torch.__version__}|device={dev.type}"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = f"cuda:{idx}"
    with _LOCK:
        if key not in _FINGERPRINTS:
            major, minor = torch.cuda.get_device_capability(idx)
            ver = _nvcc_version(nvcc_path())
            libs = ",".join(_target(name, ver).stem for name in SOURCES)
            _FINGERPRINTS[key] = (f"torch={torch.__version__}|cuda={torch.version.cuda}|"
                                  f"sm_{major}{minor}|kernels={libs}")
        return _FINGERPRINTS[key]


def build_all() -> dict[str, pathlib.Path]:
    """Compile every kernel source whose keyed binary is missing, one nvcc
    process per source, all running at once.  Returns name -> binary path.
    Every process is waited for before any failure is raised."""
    nvcc = nvcc_path()
    ver = _nvcc_version(nvcc)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name, ver) for name in SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for name, tgt in targets.items():
        if tgt.exists():
            continue
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)

    def wait(name: str) -> None:  # one thread per process, so each one's finish is timed
        BUILD_LOG[name], _ = procs[name][0].communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        list(pool.map(wait, procs))
    failed = []
    for name, (proc, tmp) in procs.items():
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("repro_torch: " + "\n".join(failed))
    return targets


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# source name -> {C entry point: its argument types}; every entry returns the
# cudaError_t of its launch as an int
_ENTRY = {
    "affine_scan": {
        # b, s, rows, V, decay, reverse, stream
        "affine_scan_launch": [_P, _P, _I, _I, _F, _I, _P],
        # alloc, x and cap, each with its (row, element) strides (cap: one);
        # occ_prev, bw_prev, code, R, V, occ decay, bw decay, bw gain, stream
        "mapper_carries_launch": [_P, _L, _L, _P, _L, _L, _P, _L, _P, _P, _P, _I, _I, _F, _F, _F, _P],
        # g_occ, g_bw with their strides, code, grad_alloc (or null), grad_x,
        # grad_cap, R, V, occ decay, bw decay, bw gain, stream
        "mapper_carries_backward_launch": [_P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P],
    },
    # graph, chw, out, V, P, lanes a design (0: the launcher's choice; others a test seam), stream
    "popsim": {"popsim_launch": [_P, _P, _P, _I, _I, _I, _P]},
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, bf16, stream
    "flash_attention": {"flash_attention_launch": [_P] * 4 + [_I] * 7 + [_F, _I, _P]},
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, stream (bf16 only)
    "flash_attention_sm90": {"flash_attention_sm90_launch": [_P] * 4 + [_I] * 7 + [_F, _P]},
    # x, dt, A, B, C, y, state, scratch, Bt, S, H, P, N, bf16, heads a block, stream
    "ssd_chunk_scan": {"ssd_chunk_scan_launch": [_P] * 8 + [_I] * 7 + [_P]},
    # u, dt, A, B, C, D, y, state, Bt, S, C, N, bf16, stream
    "selective_scan": {"selective_scan_launch": [_P] * 8 + [_I] * 5 + [_P]},
}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for entry, argtypes in _ENTRY[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _I


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built at first use).
    Each library loaded counts one ``runtime.build`` in ``instrument``."""
    with _LOCK:
        if name not in _LIBS:
            for n, path in build_all().items():
                if n not in _LIBS:
                    lib = ctypes.CDLL(str(path))
                    _bind(n, lib)
                    _LIBS[n] = lib
                    instrument.count_trace("runtime.build")
        return _LIBS[name]


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"repro_torch: launch of kernel {name!r} failed with CUDA error {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
