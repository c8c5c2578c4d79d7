"""Deterministic, resumable synthetic-token data pipeline.

Every batch is a pure function of (seed, step, arch config, shape), so a
restore from a checkpoint resumes the exact stream (the checkpoint stores
the step cursor).  A background prefetch thread keeps ``depth`` batches
ahead of the consumer, on the device.

The stream is a mixture of Zipf-distributed tokens with injected periodic
structure, so that models learn (the loss falls), unlike on uniform noise.
``DataConfig``, ``_token_block`` and ``make_batch`` are copies of the
reference's numpy code: a batch equals the reference's bit for bit.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import runtime


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    period: int = 17  # injected structure: x[t] depends on x[t-period]
    copy_prob: float = 0.7


def _token_block(rng: np.random.Generator, n: int, vocab: int, dcfg: DataConfig) -> np.ndarray:
    """1-D structured token stream of length n."""
    zipf = rng.zipf(dcfg.zipf_a, size=n).astype(np.int64)
    toks = (zipf - 1) % vocab
    p = dcfg.period
    copy = rng.random(n) < dcfg.copy_prob
    for t in range(p, n):
        if copy[t]:
            toks[t] = toks[t - p]
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, dcfg: DataConfig = DataConfig(),
               batch_override: Optional[int] = None, seq_override: Optional[int] = None) -> dict:
    """Batch for one step: dict(tokens, labels[, vision]) as numpy arrays."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    ncb = cfg.audio.n_codebooks if cfg.audio else 1
    flat = _token_block(rng, B * (S + 1) * ncb, cfg.vocab_size, dcfg)
    toks = flat.reshape(B, S + 1, ncb) if cfg.audio else flat.reshape(B, S + 1)
    batch = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
    }
    if cfg.vision:
        batch["vision"] = rng.standard_normal(
            (B, cfg.vision.n_patches, cfg.vision.d_vision), dtype=np.float32
        )
    return batch


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``: integer
    arrays as int64 (token ids index and gather), the rest float32."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        dt = torch.int64 if not (t.is_floating_point() or t.is_complex()) else torch.float32
        out[k] = t.to(device=device, dtype=dt, non_blocking=True)
    return out


class Prefetcher:
    """Background-thread prefetch of ``make_batch`` outputs, moved to
    ``device`` (None: the card), resumable from ``start_step``.  Yields
    (step, batch)."""

    def __init__(self, cfg, shape, start_step: int = 0, depth: int = 2, dcfg: DataConfig = DataConfig(),
                 device=None, **kw):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self.device = runtime.resolve_device(device)

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = batch_to(make_batch(cfg, shape, step, dcfg, **kw), self.device)
                try:
                    self._q.put((step, b), timeout=1.0)
                except queue.Full:
                    if self._stop.is_set():
                        return
                    continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
