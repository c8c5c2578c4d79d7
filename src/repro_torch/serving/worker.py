"""Worker-process entry point for multi-process design serving.

``python -m repro_torch.serving.worker --socket <path> --id <n>`` connects
back to the coordinator (:class:`repro_torch.serving.pool.MultiProcessDesignService`),
receives its construction config over the frame protocol, builds a
:class:`~repro_torch.serving.pool.StagedBatchingService` over
``Session(cache_dir=...)`` against the *shared* cache directory on the
config's device (the worker opens the card itself), and then drains query
chunks until told to shut down.  A preheated directory means the session
here rehydrates every program at construction: after ``ready`` the worker
builds nothing, and its replies are bit-identical to the parent's
sequential ones (the programs are the same closures over the same engine
functions, and the kernel libraries are the parent's binaries under
``runtime.build_dir()``, loaded, not built).

Liveness: a daemon thread beacons ``hb`` every ``heartbeat_s``.  If a
beacon (or any send) fails, the coordinator is gone and the worker exits
immediately — orphaned workers must never outlive their pool.  The
coordinator symmetrically treats heartbeat silence, socket EOF and process
exit as worker death and requeues whatever this worker never answered.

Workers are *spawned* (``subprocess``), never forked: a CUDA context does
not survive a fork (see the ``fork-unsafe`` lint rule).  A worker writes
nothing to standard output: the coordinator's standard output belongs to
its caller.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import socket
import sys
import threading

from repro_torch.serving import protocol


def _strip_raw(reply):
    """Drop ``FrontierResult.raw`` (device tensors and the full population)
    before pickling a reply onto the wire — the raw population is a
    debugging artifact, not part of the reply contract."""
    result = reply.result
    if result is not None and hasattr(result, "raw") and result.raw is not None:
        reply = dataclasses.replace(reply, result=dataclasses.replace(result, raw=None))
    return reply


def _error_replies(svc, queries, exc):
    """Structured per-query failures when a whole chunk's replies could not
    be encoded (e.g. an unpicklable result object)."""
    return [svc._last_ditch(q, exc) for q in queries]


def serve_forever(sock_path: str, worker_id: int) -> int:
    from repro_torch.serving.chaos import ChaosInjector
    from repro_torch.serving.pool import StagedBatchingService

    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock_path)
    send_lock = threading.Lock()  # heartbeat thread and reply frames interleave

    def send(tag, payload):
        frame = protocol.encode_frame(tag, payload)
        with send_lock:
            conn.sendall(frame)

    send("hello", {"worker": worker_id, "pid": os.getpid()})
    tag, cfg = protocol.recv_frame(conn)
    if tag != "cfg":
        raise protocol.ProtocolError(f"expected cfg, got {tag!r}")

    chaos = ChaosInjector(cfg["chaos"]) if cfg.get("chaos") is not None else None
    svc = StagedBatchingService(
        cfg["architecture"],
        policy=cfg["policy"],
        retry=cfg["retry"],
        deadlines=cfg["deadlines"],
        chaos=chaos,
        request_bucket=cfg["request_bucket"],
        cache_dir=cfg["cache_dir"],
        device=cfg["device"],
    )
    if cfg.get("warm"):
        svc.warmup(
            cfg["warm"],
            objectives=tuple(cfg.get("objectives") or ("edp",)),
            kinds=tuple(cfg.get("kinds") or ("simulate", "explain")),
        )
    from repro_torch.kernels import runtime

    # the kernel libraries this process compiled (none, when it found the
    # parent's binaries under runtime.build_dir() and only loaded them)
    send("ready", {"worker": worker_id, "disk_loaded": svc.session.disk_loaded,
                   "kernels_built": sorted(runtime.BUILD_LOG)})

    stop = threading.Event()

    def beacon():
        while not stop.wait(cfg["heartbeat_s"]):
            try:
                send("hb", worker_id)
            except OSError:
                os._exit(1)  # coordinator is gone; don't linger

    threading.Thread(target=beacon, name="dragon-hb", daemon=True).start()

    # frames are read ahead by their own thread.  A chunk of queries that
    # carry Workload objects, and a reply frame of per-vertex reports, can
    # each outgrow the socket's buffer: were this thread to block sending a
    # reply while the coordinator blocks sending the next chunk (the
    # backpressure allows two in flight), neither would read, and the
    # coordinator's send timeout would declare this worker dead
    inbox: queue.Queue = queue.Queue()

    def read_ahead():
        while True:
            try:
                frame = protocol.recv_frame(conn)
            except (OSError, protocol.ProtocolError):
                inbox.put(None)  # coordinator died mid-stream
                return
            inbox.put(frame)
            if frame[0] == "shutdown":
                return

    threading.Thread(target=read_ahead, name="dragon-reader", daemon=True).start()

    while True:
        frame = inbox.get()
        if frame is None:
            return 1
        tag, payload = frame
        if tag == "shutdown":
            stop.set()
            try:
                send("bye", svc.stats)
            except OSError:
                return 1  # coordinator gone; stats snapshot already piggybacked
            return 0
        if tag != "chunk":
            continue  # unknown frame: skip, stay alive
        cid, queries = payload
        replies = [_strip_raw(r) for r in svc.serve(queries)]
        try:
            frame = protocol.encode_frame("replies", (cid, replies, svc.stats))
        except Exception as e:  # unpicklable result: degrade per-query
            replies = _error_replies(svc, queries, e)
            frame = protocol.encode_frame("replies", (cid, replies, svc.stats))
        try:
            with send_lock:
                conn.sendall(frame)
        except OSError:
            return 1  # coordinator died mid-reply


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DRAGON design-serving worker process")
    ap.add_argument("--socket", required=True, help="coordinator's unix socket path")
    ap.add_argument("--id", type=int, required=True, help="worker id assigned by the coordinator")
    args = ap.parse_args(argv)
    # anything printed here (by Python or a library) goes to standard error
    sys.stdout.flush()
    os.dup2(2, 1)
    return serve_forever(args.socket, args.id)


if __name__ == "__main__":
    sys.exit(main())
