"""Persistent program cache — the programs a Session preheated, kept across restarts.

The port runs eagerly: a program is a closure over the engine functions,
bound to its cache key (``repro_torch.api``), and has no executable to
serialize.  What a cold ``(kind, spec, bucket, objective)`` costs is the
program's build, the spec's arrays on the device and, in a new process on
the card, the kernel libraries' load; ``nvcc``'s libraries themselves
already stay on disk under ``runtime.build_dir()``, keyed by hash.  So this
cache persists *which* programs a session preheated: one record per program
key.  A restarted ``Session(cache_dir=...)`` reads every record back and
rehydrates each program at construction (the same spec function
``preheat`` uses, run once on example arguments of the key's bucket), so
its first query of a preheated shape builds nothing — no build of any
``instrument`` tag — and replies bit-identically (the program is the same
closure over the same engine functions).

Keying
------

Records are addressed by :func:`cache_key_digest`: a SHA-256 over

  * a cache **schema version** (bump it to invalidate every record on a
    format change),
  * the **runtime fingerprint** (``runtime.executable_fingerprint``: torch,
    CUDA, the card's arch and every kernel library's key on the card; torch
    and the device type on the CPU — a record written under another runtime
    or other kernel sources misses cleanly),
  * a **canonical text encoding** of the Session program-cache key —
    ``(kind, ArchSpec, MapperCfg, bucket[, objective][, request bucket])``
    — encoded field by field (:func:`canonical_key_text`), never via
    Python ``hash()`` (which is salted per process).  The text equals the
    reference's for the same key.

Robustness
----------

Reads never raise.  A truncated / bit-flipped / zero-length record fails
the checksum (or unpickling) and is **quarantined** — renamed to
``*.quarantined`` so it can never be read as a cache record again, while
the bytes stay on disk for post-mortem — and the caller falls back to a
fresh build.  A schema or fingerprint mismatch is a *clean miss*: the
record is left in place (it belongs to another runtime).  Writes are
atomic (temp file + rename) so a crashed writer can never publish a torn
record.  :class:`CacheCorruption` subclasses ``TransientFault`` — the
chaos harness injects it (``ChaosConfig.p_cache_corrupt``) to prove the
retry loop clears it.

Records are pickled; a cache directory is trusted local state (like
``__pycache__``), not an interchange format — don't load cache directories
from untrusted sources.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile

from repro_torch.kernels import runtime
from repro_torch.serving.resilience import TransientFault

__all__ = [
    "AotCache",
    "CacheCorruption",
    "SCHEMA_VERSION",
    "cache_key_digest",
    "canonical_key_text",
]

SCHEMA_VERSION = 1

_MAGIC = b"DRGNKEY\x01"
_SUFFIX = ".pkey"
_QUARANTINE = ".quarantined"
_CHECKSUM_BYTES = 32  # sha256 of the body, stored right after the magic


class CacheCorruption(TransientFault):
    """A persisted record failed its checksum or unpickling.

    Transient by construction: the reader quarantines the bad file and
    falls back to a fresh build, so a retry serves from a clean slate.
    The wire code stays ``"transient"`` — no new alert class for fleets.
    """


# --------------------------------------------------------------------------- #
# key canonicalization + digest
# --------------------------------------------------------------------------- #


def canonical_key_text(key) -> str:
    """Deterministic text encoding of a Session program-cache key.

    Frozen dataclasses (``ArchSpec``, ``MapperCfg``) encode as
    ``ClassName(field=value, ...)`` over their declared fields, scalars by
    ``repr`` — every component lands in the text, so any single-field
    perturbation changes the digest, and equal keys encode equally in any
    process.
    """
    if dataclasses.is_dataclass(key) and not isinstance(key, type):
        inner = ",".join(
            f"{f.name}={canonical_key_text(getattr(key, f.name))}"
            for f in dataclasses.fields(key)
        )
        return f"{type(key).__qualname__}({inner})"
    if isinstance(key, (tuple, list)):
        return "(" + ",".join(canonical_key_text(x) for x in key) + ")"
    if key is None or isinstance(key, (bool, int, float, str)):
        return repr(key)
    raise TypeError(
        f"cache key contains an unsupported component {type(key).__name__}: {key!r}"
    )


def cache_key_digest(key, *, schema: int | None = None, fingerprint: str | None = None,
                     device=None) -> str:
    """SHA-256 hex digest addressing one persisted record.

    Covers the schema version and the runtime fingerprint (of ``device``,
    the card unless the caller names another) in addition to the key
    itself, so format changes and runtime or kernel changes both invalidate
    by *missing*, never by rehydrating under the wrong runtime.
    """
    if schema is None:
        schema = SCHEMA_VERSION
    if fingerprint is None:
        fingerprint = runtime.executable_fingerprint(device)
    text = f"dragon-aot|v{schema}|{fingerprint}|{canonical_key_text(key)}"
    return hashlib.sha256(text.encode()).hexdigest()


# --------------------------------------------------------------------------- #
# the cache
# --------------------------------------------------------------------------- #


class AotCache:
    """One directory of program keys, one file per key.

    File layout: ``dragon-<digest32>.pkey`` = magic + sha256(body) + body,
    where body pickles ``{schema, fingerprint, key_text, key}``.  The
    fingerprint is the runtime of ``device`` (the card unless the caller
    names another), read once at construction.  All read paths return
    misses instead of raising; corrupt files are quarantined via
    :meth:`_quarantine`.
    """

    def __init__(self, path, *, device=None):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.fingerprint = runtime.executable_fingerprint(device)
        self.loaded = 0  # records read back valid
        self.written = 0  # records persisted by this process
        self.rejected = 0  # clean misses: schema/fingerprint from another runtime
        self.quarantined = 0  # corrupt files renamed out of the namespace

    # -------------------------------------------------------------- naming --
    def _file(self, key) -> str:
        digest = cache_key_digest(key, fingerprint=self.fingerprint)
        return os.path.join(self.path, f"dragon-{digest[:32]}{_SUFFIX}")

    def entries(self) -> list[str]:
        """Record file names currently in the directory (sorted)."""
        return sorted(n for n in os.listdir(self.path) if n.endswith(_SUFFIX))

    # ------------------------------------------------------------- writing --
    def put(self, key) -> bool:
        """Persist one program key; returns True iff a new record was written.

        Skips keys already on disk — persisting is best-effort, serving
        never depends on it.
        """
        path = self._file(key)
        if os.path.exists(path):
            return False
        body = pickle.dumps(
            dict(
                schema=SCHEMA_VERSION,
                fingerprint=self.fingerprint,
                key_text=canonical_key_text(key),
                key=key,
            ),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        # multi-writer safe: writers racing the same digest each write a
        # private tmp (mkstemp randomizes the name; the pid suffix makes a
        # stray tmp attributable post-mortem) and publish via atomic rename —
        # last rename wins with byte-identical content, readers never observe
        # a torn file
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=f".{os.getpid()}.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC + hashlib.sha256(body).digest() + body)
            os.replace(tmp, path)  # atomic publish: readers see whole files only
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.written += 1
        return True

    # ------------------------------------------------------------- reading --
    def get(self, key):
        """The persisted key equal to ``key``, or None (miss / rejected /
        quarantined).  Never raises."""
        path = self._file(key)
        if not os.path.exists(path):
            return None
        record = self._read_record(path)
        if record is None:
            return None
        if record["key"] != key:
            # digest collision or a tampered record: impossible by
            # construction, so treat as corruption
            self._quarantine(path)
            return None
        self.loaded += 1
        return record["key"]

    def load_all(self) -> list:
        """Every valid record's program key, in file-name order — the
        restart path: ``Session(cache_dir=...)`` rehydrates each."""
        out: list = []
        for name in self.entries():
            record = self._read_record(os.path.join(self.path, name))
            if record is not None:
                self.loaded += 1
                out.append(record["key"])
        return out

    def _read_record(self, path: str) -> dict | None:
        """Read + verify one record file.  None on any failure: corruption is
        quarantined, foreign schema/fingerprint is a clean miss."""
        try:
            with open(path, "rb") as f:
                payload = f.read()
            header = len(_MAGIC) + _CHECKSUM_BYTES
            if len(payload) < header or not payload.startswith(_MAGIC):
                raise CacheCorruption(f"bad header: {os.path.basename(path)}")
            body = payload[header:]
            if hashlib.sha256(body).digest() != payload[len(_MAGIC):header]:
                raise CacheCorruption(f"checksum mismatch: {os.path.basename(path)}")
            record = pickle.loads(body)
            if (
                not isinstance(record, dict)
                or "key" not in record
                or record.get("key_text") != canonical_key_text(record["key"])
            ):
                raise CacheCorruption(f"malformed record: {os.path.basename(path)}")
        except Exception:
            self._quarantine(path)
            return None
        if (
            record.get("schema") != SCHEMA_VERSION
            or record.get("fingerprint") != self.fingerprint
        ):
            self.rejected += 1
            return None
        return record

    def reject(self, key) -> None:
        """Quarantine ``key``'s record: it verified, but the session could
        not rebuild a program from it (the reference's counterpart is an
        executable the runtime refuses after its checksum passed)."""
        path = self._file(key)
        if os.path.exists(path):
            self._quarantine(path)

    def _quarantine(self, path: str) -> None:
        """Rename, never delete: the bytes stay for post-mortem and can
        never be read as a cache record again."""
        dst = path + _QUARANTINE
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{path}{_QUARANTINE}.{n}"
        try:
            os.replace(path, dst)
        except OSError:
            return  # already quarantined/removed by a concurrent reader
        self.quarantined += 1
