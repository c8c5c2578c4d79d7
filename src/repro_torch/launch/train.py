"""Training launcher: the Trainer on a device mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
      --reduced --steps 20 --batch 8 --seq 256 [--device cpu] [--ckpt-dir DIR]
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch granite-3-8b --production-mesh

The reference's CLI, plus ``--device`` (the card unless named).  It trains
under ``make_local_mesh()`` over the process group (``mesh.process_group``:
``torchrun``'s, or one rank of its own); ``--production-mesh`` takes the
16x16 mesh instead and raises unless the group has 256 ranks.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, process_group
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None, help="override global batch")
    ap.add_argument("--seq", type=int, default=None, help="override seq len")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (needs 256 ranks)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    with process_group(args.device):
        mesh = make_production_mesh() if args.production_mesh else make_local_mesh()
        return _train(args, mesh)


def _train(args, mesh) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    shape = SHAPES.get(args.shape) or ShapeConfig(args.shape, args.seq or 512, args.batch or 8, "train")
    opt = AdamWConfig(lr=args.lr, schedule=warmup_cosine(args.warmup, args.steps), int8_states=args.int8_opt)
    tcfg = TrainConfig(microbatches=args.microbatches, compress_grads=args.compress_grads)
    rcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                         batch_override=args.batch, seq_override=args.seq)
    trainer = Trainer(model, shape, opt, tcfg, rcfg, device=args.device, mesh=mesh)
    out = trainer.run()
    print(f"[train] {args.arch}: {len(out['losses'])} steps, "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{out['wall']:.1f}s, {len(out['stragglers'])} stragglers flagged")
    return out


if __name__ == "__main__":
    main()
