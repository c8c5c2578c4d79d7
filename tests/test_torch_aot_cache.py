"""Port conformance: the persistent program cache behind ``Session(cache_dir=...)``.

The port persists program *keys* (a program is an eager closure; see
``repro_torch.serving.aotcache``) under the reference's format rules.  Four
contracts:

  * keying — ``canonical_key_text`` of a port key equals the reference's for
    the same key, the digest equals the reference's under the same
    fingerprint, and every single-field perturbation of the key changes it;
  * corruption — a torn record, a flipped byte, a wrong magic, an unpicklable
    or malformed body are quarantined (renamed, never read again), and the
    session rebuilds the program with the same reply; reads never raise;
  * foreign runtime — a record of another fingerprint or schema is a clean
    miss, left in place;
  * restart — across two processes that import only ``repro_torch``, a
    ``DesignService`` over one ``cache_dir`` passes the restart gate: zero
    builds of any tag after construction, ``misses == 0``, ``disk_loaded``
    equal to the first process's ``persisted``, replies equal as ``to_json``
    strings, and the first query predicted warm.

Everything runs on the CPU with ``device="cpu"``.
"""
import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import pytest

import repro.serving.aotcache as jaot
from repro.core.mapper import MapperCfg as jMapperCfg
from repro.core.params import ArchSpec as jArchSpec
from repro_torch.api import Session
from repro_torch.core import instrument
from repro_torch.core.mapper import MapperCfg
from repro_torch.core.params import ArchSpec
from repro_torch.kernels import runtime
from repro_torch.serving import aotcache
from repro_torch.serving.aotcache import AotCache, CacheCorruption, cache_key_digest, canonical_key_text
from repro_torch.serving.resilience import classify_exception

CPU = "cpu"
_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _keys(spec_cls, mcfg_cls) -> dict:
    spec, mcfg = spec_cls(), mcfg_cls()
    return {
        "report": ("report", spec, mcfg, (1, 32)),
        "simulate": ("simulate", spec, mcfg, (5, 1024)),
        "explain": ("explain", spec, mcfg, (1, 32), "edp"),
        "report_batched": ("report_batched", spec, mcfg, (4, 64), 8),
        "explain_batched": ("explain_batched", spec, mcfg, (1, 32), "mixed", 16),
        "streaming_off": ("report", spec, dataclasses.replace(mcfg, streaming=False), (11, 256)),
    }


# every entry perturbs exactly one component of the base key (or its length)
_PERTURBATIONS = {
    "kind": lambda k: ("explain",) + k[1:],
    "spec.mem_type": lambda k: (k[0], dataclasses.replace(k[1], mem_type=("sram", "rram", "dram")), k[2], k[3]),
    "spec.mem_units": lambda k: (k[0], dataclasses.replace(k[1], mem_units=("l0", "l1", "l2")), k[2], k[3]),
    "mcfg.headroom": lambda k: (k[0], k[1], dataclasses.replace(k[2], headroom=0.8), k[3]),
    "mcfg.prefetch": lambda k: (k[0], k[1], dataclasses.replace(k[2], prefetch=False), k[3]),
    "mcfg.scan_impl": lambda k: (k[0], k[1], dataclasses.replace(k[2], scan_impl="ref"), k[3]),
    "bucket.w": lambda k: (k[0], k[1], k[2], (2, 32)),
    "bucket.v": lambda k: (k[0], k[1], k[2], (1, 64)),
    "objective appended": lambda k: k + ("edp",),
    "request bucket appended": lambda k: k + ("edp", 8),
}
_BASE = "report"
_FP = "torch=2.0|device=cpu"


# --------------------------------------------------------------------------- #
# keying
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(_keys(ArchSpec, MapperCfg)))
def test_canonical_key_text_equals_reference(name):
    port, ref = _keys(ArchSpec, MapperCfg)[name], _keys(jArchSpec, jMapperCfg)[name]
    assert canonical_key_text(port) == jaot.canonical_key_text(ref)
    assert cache_key_digest(port, fingerprint=_FP) == jaot.cache_key_digest(ref, fingerprint=_FP)


@pytest.mark.parametrize("label", list(_PERTURBATIONS))
def test_perturbed_key_text_equals_reference_and_changes_digest(label):
    port = _PERTURBATIONS[label](_keys(ArchSpec, MapperCfg)[_BASE])
    ref = _PERTURBATIONS[label](_keys(jArchSpec, jMapperCfg)[_BASE])
    assert canonical_key_text(port) == jaot.canonical_key_text(ref)
    base = _keys(ArchSpec, MapperCfg)[_BASE]
    assert cache_key_digest(port, fingerprint=_FP) != cache_key_digest(base, fingerprint=_FP)


def test_perturbations_pairwise_distinct():
    base = _keys(ArchSpec, MapperCfg)[_BASE]
    digests = {cache_key_digest(p(base), fingerprint=_FP) for p in _PERTURBATIONS.values()}
    assert len(digests) == len(_PERTURBATIONS)


def test_digest_covers_schema_and_fingerprint():
    k = _keys(ArchSpec, MapperCfg)[_BASE]
    d = cache_key_digest(k, fingerprint=_FP)
    assert cache_key_digest(k, fingerprint=_FP, schema=aotcache.SCHEMA_VERSION + 1) != d
    assert cache_key_digest(k, fingerprint="torch=2.0|device=cuda") != d
    assert cache_key_digest(k, device=CPU) == cache_key_digest(k, fingerprint=runtime.executable_fingerprint(CPU))


def test_unsupported_component_rejected():
    with pytest.raises(TypeError, match="unsupported component"):
        canonical_key_text(("report", object()))


def test_cpu_fingerprint_runs_no_nvcc(monkeypatch):
    import torch

    def no_nvcc():
        raise AssertionError("nvcc asked on the CPU")

    monkeypatch.setattr(runtime, "nvcc_path", no_nvcc)
    assert runtime.executable_fingerprint(CPU) == f"torch={torch.__version__}|device=cpu"


def test_cache_corruption_classifies_transient():
    fault = classify_exception(CacheCorruption("torn record"))
    assert (fault.code, fault.retryable) == ("transient", True)


# --------------------------------------------------------------------------- #
# corruption, foreign runtimes, preheat
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def preheated(tmp_path_factory):
    """One preheated cache dir (a single report program) and the reply of the
    session that built it — copied per corruption test."""
    d = str(tmp_path_factory.mktemp("pkey-pristine"))
    sess = Session("base", cache_dir=d, device=CPU)
    info = sess.preheat(["lstm"], kinds=("simulate",))
    assert (info["built"], info["persisted"]) == (1, 1)
    return dict(dir=d, ref=sess.simulate("lstm").to_json())


def _copy(preheated, tmp_path) -> str:
    dst = str(tmp_path / "cache")
    shutil.copytree(preheated["dir"], dst)
    return dst


def _entry(d: str) -> str:
    entries = [n for n in os.listdir(d) if n.endswith(".pkey")]
    assert len(entries) == 1
    return os.path.join(d, entries[0])


def _corrupt(path: str, mode: str) -> None:
    data = open(path, "rb").read()
    header = len(aotcache._MAGIC) + aotcache._CHECKSUM_BYTES
    if mode == "torn":
        data = data[: len(data) // 2]
    elif mode == "zero_length":
        data = b""
    elif mode == "bit_flip":
        b = bytearray(data)
        b[len(b) // 2] ^= 0xFF
        data = bytes(b)
    elif mode == "wrong_magic":
        data = b"XXXXXXXX" + data[len(aotcache._MAGIC):]
    elif mode in ("unpicklable", "malformed"):
        import hashlib

        body = b"\x80\x05not a pickle at all" if mode == "unpicklable" else pickle.dumps(
            dict(schema=aotcache.SCHEMA_VERSION, fingerprint=runtime.executable_fingerprint(CPU),
                 key_text="('report')", key=("report", ArchSpec(), MapperCfg(), (1, 32))))
        data = data[:len(aotcache._MAGIC)] + hashlib.sha256(body).digest() + body
        assert len(data) >= header
    else:  # pragma: no cover
        raise AssertionError(mode)
    with open(path, "wb") as f:
        f.write(data)


MODES = ("torn", "zero_length", "bit_flip", "wrong_magic", "unpicklable", "malformed")


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_record_quarantined_and_rebuilt(mode, tmp_path, preheated):
    d = _copy(preheated, tmp_path)
    _corrupt(_entry(d), mode)
    sess = Session("base", cache_dir=d, device=CPU)
    assert sess.disk_loaded == 0 and sess.programs == {}
    assert sess._aot.quarantined == 1
    names = os.listdir(d)
    assert not any(n.endswith(".pkey") for n in names) and any(".quarantined" in n for n in names)
    rep = sess.simulate("lstm")
    assert sess.stats.traces == 1 and rep.to_json() == preheated["ref"]
    assert sess.simulate("lstm").to_json() == preheated["ref"] and sess.stats.traces == 1


@pytest.mark.parametrize("mode", MODES)
def test_reads_never_raise(mode, tmp_path, preheated):
    d = _copy(preheated, tmp_path)
    _corrupt(_entry(d), mode)
    cache = AotCache(d, device=CPU)
    assert cache.get(("report", ArchSpec(), MapperCfg(), (1, 32))) is None
    assert cache.load_all() == [] and cache.quarantined == 1


def test_quarantine_keeps_both_bad_files(tmp_path, preheated):
    d = _copy(preheated, tmp_path)
    path = _entry(d)
    _corrupt(path, "bit_flip")
    cache = AotCache(d, device=CPU)
    assert cache.load_all() == []
    shutil.copy(os.path.join(preheated["dir"], os.path.basename(path)), path)
    _corrupt(path, "torn")
    assert cache.load_all() == []
    assert sum(".quarantined" in n for n in os.listdir(d)) == 2


def test_foreign_fingerprint_is_a_clean_miss(tmp_path):
    d = str(tmp_path)
    other = AotCache(d, device=CPU)
    other.fingerprint = "torch=9.9|cuda=99.9|sm_100|kernels=affine_scan-0000"
    assert other.put(("report", ArchSpec(), MapperCfg(), (1, 32)))
    sess = Session("base", cache_dir=d, device=CPU)
    assert sess.disk_loaded == 0 and sess._aot.rejected == 1 and sess._aot.quarantined == 0
    assert any(n.endswith(".pkey") for n in os.listdir(d))  # it belongs to another runtime


def test_foreign_schema_is_a_clean_miss(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setattr(aotcache, "SCHEMA_VERSION", aotcache.SCHEMA_VERSION + 1)
    assert AotCache(d, device=CPU).put(("report", ArchSpec(), MapperCfg(), (1, 32)))
    monkeypatch.undo()
    cache = AotCache(d, device=CPU)
    assert cache.load_all() == [] and cache.rejected == 1 and cache.quarantined == 0
    assert cache.get(("report", ArchSpec(), MapperCfg(), (1, 32))) is None


def test_record_naming_no_program_is_rejected(tmp_path):
    d = str(tmp_path)
    assert AotCache(d, device=CPU).put(("frontier", ArchSpec(), MapperCfg(), (1, 32)))
    sess = Session("base", cache_dir=d, device=CPU)
    assert sess.disk_loaded == 0 and sess.programs == {} and sess._aot.quarantined == 1


def test_pristine_copy_rehydrates_without_a_build(tmp_path, preheated):
    d = _copy(preheated, tmp_path)
    sess = Session("base", cache_dir=d, device=CPU)
    assert sess.disk_loaded == 1
    before = instrument.snapshot()
    assert sess.simulate("lstm").to_json() == preheated["ref"]
    assert instrument.snapshot() == before
    assert (sess.stats.traces, sess.stats.misses, sess.stats.hits) == (0, 0, 1)
    info = sess.preheat(["lstm"], kinds=("simulate",))
    assert info == dict(programs=1, built=0, reused=1, persisted=0, seconds=info["seconds"])


def test_preheat_by_bucket_tuple_persists_every_kind(tmp_path, preheated):
    sess = Session("base", cache_dir=str(tmp_path), device=CPU)
    info = sess.preheat([(1, 32)], kinds=("simulate", "explain", "perf"), request_buckets=(4,))
    assert (info["built"], info["persisted"]) == (5, 5)  # perf, report, explain; batched at 4: both
    assert sess.simulate("lstm").to_json() == preheated["ref"]
    again = Session("base", cache_dir=str(tmp_path), device=CPU)
    assert again.disk_loaded == 5 and sorted(map(repr, again.programs)) == sorted(map(repr, sess.programs))


def test_record_written_after_construction_rehydrates_in_preheat(tmp_path, preheated):
    d = str(tmp_path)
    sess = Session("base", cache_dir=d, device=CPU)
    Session("base", cache_dir=d, device=CPU).preheat(["lstm"], kinds=("simulate",))  # another writer
    info = sess.preheat(["lstm"], kinds=("simulate",))
    assert (info["built"], info["reused"], info["persisted"]) == (0, 1, 0) and sess.stats.traces == 0
    assert sess.simulate("lstm").to_json() == preheated["ref"]


def test_preheat_without_cache_dir_persists_nothing():
    info = Session("base", device=CPU).preheat([(1, 32)], kinds=("simulate",))
    assert (info["built"], info["persisted"]) == (1, 0)


# --------------------------------------------------------------------------- #
# cross-process restart
# --------------------------------------------------------------------------- #

_SERVE = r"""
import json, sys
from repro_torch.core import instrument
from repro_torch.serving import DesignQuery, DesignService

svc = DesignService("base", cache_dir=sys.argv[1], request_bucket=8, device="cpu")
info = svc.warmup(["lstm"], kinds=("simulate", "explain")) if sys.argv[2] == "warmup" else None
before = instrument.snapshot()
qs = [DesignQuery(i, ("simulate", "explain")[i % 2], ("lstm", "merge_sort")[(i // 2) % 2],
                  architecture=(None, "edge")[(i // 4) % 2]) for i in range(8)]
replies = svc.serve(qs)
sim = svc.session.simulate("lstm").to_json()
expl = svc.session.explain("lstm").to_json()
after = instrument.snapshot()
print(json.dumps(dict(
    info=info, disk_loaded=svc.session.disk_loaded, misses=svc.stats.misses,
    built={k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)},
    replies=[r.result.to_json() if r.ok else None for r in replies], compiled=[r.compiled for r in replies],
    deadline0=replies[0].deadline_s, warm_s=svc.deadlines.warm_s, sim=sim, expl=expl,
    foreign=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))))
"""


def _child(*argv: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _SERVE, *argv], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, f"child failed:\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def restart(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pkey-restart"))
    return _child(d, "warmup"), _child(d, "restart")


def test_restart_children_import_only_the_port(restart):
    assert restart[0]["foreign"] == [] and restart[1]["foreign"] == []


def test_restart_loads_what_was_persisted(restart):
    pre, post = restart
    assert pre["info"]["persisted"] == pre["info"]["built"] == 4  # report, explain; batched at 8: both
    assert post["disk_loaded"] == pre["info"]["persisted"]


def test_restart_builds_nothing_after_construction(restart):
    _, post = restart
    assert post["built"] == {} and post["misses"] == 0 and not any(post["compiled"])


def test_restart_replies_equal(restart):
    pre, post = restart
    assert all(post["replies"]) and post["replies"] == pre["replies"]
    assert (post["sim"], post["expl"]) == (pre["sim"], pre["expl"])


def test_restart_first_query_predicted_warm(restart):
    pre, post = restart
    assert post["deadline0"] == post["warm_s"] == pre["deadline0"]
