"""The traced window: ``torch.profiler`` over a fixed number of calls, read
back from its Chrome trace.

What a per-layer reader gets (:class:`Trace`): the device kernels that the
program launched in the window (name, start and length), the window's length
and the union of the device's busy intervals (every kernel, copy and fill,
the client's own draws between calls included), the work done in it (epochs
or requests) and the K1 shapes.  The benchmark's own spans delimit the
window (``chipbench::window``) and each call into the program
(``chipbench::<entry>``, a ``record_function`` range opened by the harness);
a kernel is the program's when the runtime call that launched it (matched by
its correlation id) falls inside a call's span.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

WINDOW_SPAN = "chipbench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


@dataclasses.dataclass
class Trace:
    kernels: list  # (name, start_us, dur_us) of every kernel the program launched in the window
    window_s: float
    busy_s: float
    work: dict  # "epochs" / "requests" done in the window
    shapes: dict  # "k1": (R, V)
    breakdown: dict


@contextlib.contextmanager
def profiled(out: dict, cuda: bool = True):
    """Profile the block (CPU and, with ``cuda``, CUDA activity) inside the
    window span; on exit, fill ``out`` with the parsed events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(parse(events))


def parse(events: list) -> dict:
    """Device kernels, busy time, window and breakdown from Chrome-trace events."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation" and e["name"].startswith("chipbench::")
                   and e["name"] != WINDOW_SPAN)
    starts_c = [c[0] for c in calls]

    def in_call(t: float) -> bool:
        i = bisect.bisect_right(starts_c, t) - 1
        return i >= 0 and t <= calls[i][1]

    launched = {e["args"]["correlation"] for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {}) and in_call(e["ts"])}
    kernels = [(e["name"], e["ts"], e["dur"]) for e in dev
               if e["cat"] == "kernel" and e.get("args", {}).get("correlation") in launched]
    merged = []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = b
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    by_host: dict = {}
    for a, b in gaps:
        name = _host_at(host, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    by_op: dict = {}
    for name, _, dur in kernels:
        by_op[name] = by_op.get(name, 0.0) + dur / 1e6
    top = lambda d: [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return dict(kernels=kernels, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                breakdown={"device_ops": top(by_op), "idle_gaps": top(by_host)})


def _short(name: str) -> str:
    """A kernel's name without its namespaces' noise, at most 160 letters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:160]


def _host_at(host: list, starts: list, t: float, depth: int = 400) -> str:
    """The innermost host event running at ``t`` (the latest started one that
    has not ended), or ``python`` when the host ran none of them."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"
