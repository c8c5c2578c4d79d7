"""Serving launcher: batched requests through the continuous-batching engine
on a device mesh (``make_local_mesh()`` over the process group:
``torchrun``'s, or one rank of its own).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b --reduced \
      --requests 8 --max-tokens 16 [--device cpu]

The reference's CLI, plus ``--device`` (the card unless named).  Weights are
drawn from ``torch.Generator(device).manual_seed(0)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh, process_group
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, Request


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    with process_group(args.device):
        return _serve(args, make_local_mesh())


def _serve(args, mesh) -> list:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(0, args.device)
    eng = Engine(model, params, slots=args.slots, max_len=args.max_len, device=args.device, mesh=mesh)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        shape = (args.prompt_len, cfg.audio.n_codebooks) if cfg.audio else (args.prompt_len,)
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
                           max_tokens=args.max_tokens, temperature=args.temperature, seed=i))
    done = eng.run()
    wall = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.t_first - r.t_submit for r in done]
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks/wall:.1f} tok/s); mean TTFT {np.mean(ttfts)*1e3:.0f} ms")
    return done


if __name__ == "__main__":
    main()
