"""The token engine: continuous batching of requests over decode slots.

A free slot is prefilled with an incoming prompt (the prefill cache is written
into that slot's rows of the engine's cache, in place), then joins the batched
decode step; a finished sequence (eos or max_tokens) frees its slot.  Per-slot
cache lengths make ragged decoding exact.

Prefill is exact-length: the recurrent families this package serves fold
every prompt position into their state, so a padded prompt would corrupt it.

Sampling is greedy (argmax) or by temperature with Gumbel noise drawn from a
``torch.Generator`` seeded from (seed, rid, position): deterministic within
this package, and not the reference's ``jax.random`` stream.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.models.model import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S]
    max_tokens: int = 32
    temperature: float = 0.0
    eos: Optional[int] = None
    seed: int = 0
    # filled by the engine (host clock, seconds; prefill time is t_first - t_admit)
    generated: list = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _stream_seed(*parts: int) -> int:
    digest = hashlib.blake2b(":".join(map(str, parts)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class Engine:
    def __init__(self, model: Model, params: dict, *, slots: int = 4, max_len: int = 512, device=None):
        self.device = runtime.resolve_device(device)
        self.model = model
        self.slots, self.max_len = slots, max_len
        # prompt bucketing is exact only for causal kv-cache families; the
        # recurrent ones keep exact-length prefill
        self._bucket_prompts = model.cache_dims()["kind"] in ("kv", "kv+x")
        # cast once here, not at every step
        self.params = model.precast(params)
        self.cache = model.init_cache(slots, max_len, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._next_tok = np.zeros((slots, 1), np.int64)

    # ------------------------------------------------------------ intake --
    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------- cache plumb --
    def _write_slot(self, slot: int, src_cache: dict):
        """Copy one request's prefill cache (batch 1) into slot ``slot``, in place."""
        for k, dst in self.cache.items():
            if k == "len":
                dst[slot] = src_cache[k][0]
            else:  # [L, B, ...]
                dst[:, slot] = src_cache[k][:, 0]

    # --------------------------------------------------------------- step --
    def step(self) -> bool:
        """One engine iteration: admit and prefill new requests, then one
        batched decode step for all active slots."""
        for slot in range(self.slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.t_admit = time.perf_counter()
                prompt = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)[None]
                logits, cache1 = self.model.prefill(self.params, prompt, max_len=self.max_len)
                self._write_slot(slot, cache1)
                tok = self._sample(req, logits[0].cpu().numpy())
                req.t_first = time.perf_counter()
                req.generated.append(tok)
                self._next_tok[slot] = tok
                self.slot_req[slot] = req
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return False
        # batched decode (inactive slots decode garbage into their own lane)
        tokens = torch.as_tensor(self._next_tok, device=self.device)
        logits, self.cache = self.model.decode_step(self.params, tokens, self.cache)
        logits = logits.cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            tok = self._sample(req, logits[slot])
            req.generated.append(tok)
            self._next_tok[slot] = tok
            if len(req.generated) >= req.max_tokens or (req.eos is not None and tok == req.eos):
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                self.slot_req[slot] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------ sample --
    def _sample(self, req: Request, logits: np.ndarray) -> int:
        """logits: [V] float32."""
        if req.temperature <= 0.0:
            return int(logits.argmax(-1))
        gen = torch.Generator().manual_seed(_stream_seed(req.seed, req.rid, len(req.generated)))
        gumbel = -torch.empty(logits.shape, dtype=torch.float64).exponential_(generator=gen).log()
        return int((logits / req.temperature + gumbel.numpy()).argmax(-1))
