"""Fault-tolerant checkpointing: atomic and async, in the reference's format.

Protocol (crash-consistent):
  1. write all leaf arrays + manifest into  <dir>/step_N.tmp/
  2. fsync, then os.replace -> <dir>/step_N     (atomic on POSIX)
  3. prune to the newest ``keep`` checkpoints.
A crash mid-write leaves only a .tmp dir, which restore ignores and the next
save overwrites: no torn checkpoints.

Async mode copies the state to host memory (blocking only on the copy: the
train step updates its tensors in place), then writes the files on a
background thread; a write's error is raised by the next ``wait()``.

On disk: ``manifest.json`` ({"step", "extra", "leaves": [{"path", "file"}]})
and one ``.npy`` a leaf, each leaf named by its ``jax.tree_util.keystr`` key
path (``['params']['layers']['wq']``, ``['opt']['m']['layers']['wq'].codes``,
``['step']``; ``repro_torch.tree``), so a checkpoint of either package
restores in the other.  bf16 leaves are stored as float32 (numpy has no
bf16) and cast back to the ``like`` leaf's type on restore.

A state on a device mesh (DTensor leaves): ``save`` gathers each leaf whole
on every rank (a collective, so every rank calls it) and rank 0 of the
process group writes the files; ``restore(shardings=)`` loads each leaf
whole and distributes it onto its placements.  The files are the same as
one device's, so a checkpoint moves between meshes of any shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.kernels import runtime
from repro_torch.models.sharding import distribute, is_dtensor


def _writer() -> bool:
    """Whether this process writes checkpoint files: rank 0 of a started
    process group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()

def _to_host(x) -> np.ndarray:
    """A copy on the host (never a view: the caller's tensor changes in place);
    a DTensor gathered whole first."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if is_dtensor(x):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state, extra: Optional[dict] = None):
        """Copy to the host, then write (async by default)."""
        self.wait()  # one in-flight save at a time
        host = [(path, _to_host(x)) for path, x in tu.leaves_with_path(state)]
        extra = dict(extra or {})
        if not _writer():
            return
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra)
            self.wait()

    def wait(self):
        """Wait for the save in flight (and, under a process group of several
        ranks, for every rank: the writer's files are then on disk for all)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: list, extra: dict):
        try:
            tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                return  # already checkpointed (deterministic content)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra, "leaves": []}
            for i, (path, val) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), val)
                manifest["leaves"].append({"path": path, "file": fn})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            self._prune()
        except BaseException as e:  # noqa: BLE001  (surfaced, re-raised, by the next wait())
            self._error = e

    def _done(self) -> list[str]:
        return sorted(d for d in os.listdir(self.dir) if d.startswith("step_") and not d.endswith(".tmp"))

    def _prune(self):
        for d in self._done()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        done = self._done()
        return int(done[-1].split("_")[1]) if done else None

    def restore(self, step: Optional[int], like, device=None, shardings=None) -> tuple[Any, dict]:
        """Rebuild the state tree (``step`` None: the latest).  ``like`` gives
        the structure and each leaf's dtype: a tree of tensors, or of meta
        tensors (``train.abstract_train_state``).  Leaves land on ``device``
        (None: the card); with ``shardings`` (``launch.specs.as_placements``:
        a tree of ``NamedPlacements`` of ``like``'s structure, None for a
        plain leaf) each leaf is distributed onto its placements.  Returns (state, the save's
        ``extra``)."""
        dev = runtime.resolve_device(device)
        places = None
        if shardings is not None:  # a NamedPlacements (or None: a plain tensor) per leaf of like
            places = tu.leaves(shardings, lambda x: x is None or hasattr(x, "placements"))
            if len(places) != len(tu.leaves(like)):
                raise ValueError(f"restore: shardings has {len(places)} leaves, like has {len(tu.leaves(like))}")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {leaf["path"]: leaf["file"] for leaf in manifest["leaves"]}
        vals = []
        for path, leaf_like in tu.leaves_with_path(like):
            if path not in by_path:
                raise KeyError(f"checkpoint step {step} in {self.dir} has no leaf {path}")
            arr = np.load(os.path.join(d, by_path[path]))
            t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
            if isinstance(leaf_like, torch.Tensor):
                if tuple(t.shape) != tuple(leaf_like.shape):
                    raise ValueError(f"{path}: shape {tuple(t.shape)} in the checkpoint, {tuple(leaf_like.shape)} "
                                     "expected")
                t = t.to(leaf_like.dtype)
            t = t.to(dev)
            where = None if places is None else places[len(vals)]
            if where is not None:
                t = distribute(t, where.mesh, where.spec)
            vals.append(t)
        return tu.unflatten_like(like, vals), manifest["extra"]
