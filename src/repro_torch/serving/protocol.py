"""Length-prefixed frame protocol for coordinator <-> worker links.

The multi-process serving tier (:mod:`repro_torch.serving.pool` /
:mod:`repro_torch.serving.worker`) talks over a private Unix-domain socket
the coordinator creates, one connection per worker process it spawned.  The
wire format is deliberately tiny, and the reference package's byte for byte
(a frame either package encodes decodes with the other's :func:`recv_frame`):

    ``MAGIC (4 bytes) | length (u32, big-endian) | body``

where ``body = pickle((tag, payload))``.  Frames carry whole chunks of
queries / replies, so per-frame overhead amortizes across the request
bucket.

Tags (direction):

| tag        | dir  | payload |
|------------|------|---------|
| ``hello``  | w->c | ``{"worker": id, "pid": pid}`` — first frame after connect |
| ``cfg``    | c->w | service construction dict (policy/retry/deadlines/chaos/cache_dir/device/...) |
| ``ready``  | w->c | ``{"worker": id, "disk_loaded": n}`` — service built + warmed, taking traffic |
| ``chunk``  | c->w | ``(chunk_id, [DesignQuery, ...])`` |
| ``replies``| w->c | ``(chunk_id, [DesignReply, ...], ServiceStats)`` — stats piggyback on every reply frame so the coordinator's fleet view survives a later crash |
| ``hb``     | w->c | worker id — liveness beacon from a daemon thread |
| ``shutdown``| c->w| None — drain and exit |
| ``bye``    | w->c | final ``ServiceStats`` |

Pickle is safe here because the channel is *private by construction*: the
socket lives in a coordinator-owned temp directory (mode 0700) and both
ends are processes the coordinator spawned — never a network listener,
never untrusted peers.  A pickled tensor (a query's ``Workload`` object)
restores on the device it was saved from, which is the worker's: the
coordinator and its workers run on one device.  :exc:`ProtocolError`
covers the failure modes a crashing peer can produce (EOF mid-frame, bad
magic, absurd length), so the coordinator can classify any framing problem
as worker death.

Pure stdlib: a worker stub or a test may load this file alone.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Tuple

MAGIC = b"DGN1"
_HEADER = struct.Struct(">4sI")

#: hard ceiling on one frame's body — a length prefix beyond this is a
#: corrupt/foreign stream, not a real chunk (the largest legitimate frame,
#: a full request bucket of explain replies or of LM-cell queries, is
#: well under 1 MB)
MAX_FRAME = 64 * 1024 * 1024


class ProtocolError(RuntimeError):
    """Framing violation: truncated stream, bad magic, oversized length.
    The coordinator treats any of these as death of the peer."""


def encode_frame(tag: str, payload: Any) -> bytes:
    """One wire frame.  Split from :func:`send_frame` so a sender can fail
    on an unpicklable payload *before* writing anything — a half-written
    frame would corrupt the stream for every later message."""
    body = pickle.dumps((tag, payload), protocol=pickle.HIGHEST_PROTOCOL)
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame {tag!r} is {len(body)} bytes (max {MAX_FRAME})")
    return _HEADER.pack(MAGIC, len(body)) + body


def send_frame(sock, tag: str, payload: Any) -> None:
    sock.sendall(encode_frame(tag, payload))


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        part = sock.recv(n - got)
        if not part:
            raise ProtocolError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


def recv_frame(sock) -> Tuple[str, Any]:
    """Read one complete frame; blocks until it arrives.  Raises
    :exc:`ProtocolError` on EOF / framing violations (a clean EOF *between*
    frames raises too — callers treat it as the peer leaving)."""
    magic, length = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds {MAX_FRAME}")
    tag, payload = pickle.loads(_recv_exact(sock, length))
    return tag, payload
