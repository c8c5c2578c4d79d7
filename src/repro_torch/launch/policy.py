"""Per-(arch, shape) parallelism policy — the §Perf hillclimb outcome.

"tp"  — model axis = tensor/expert parallel (attention heads, ffn, experts,
        vocab).  Required for: MoE (expert parallelism), decode (batch too
        small to feed 256-way DP), and anything whose optimizer state
        doesn't fit without TP.
"dp"  — model axis folds into data parallelism + ZeRO-3 parameter sharding.
        Wins for dense/SSM/hybrid TRAIN at 1M-token global batch: per-layer
        TP activation all-gathers collapse to ZeRO-3's parameter gathers.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def parallelism_for(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256) -> str:
    if cfg.family == "moe":
        return "tp"  # expert parallelism lives on the model axis
    if shape.kind != "train":
        return "tp"  # decode/prefill batches can't feed 256-way DP
    if shape.global_batch % chips != 0:
        return "tp"
    return "dp"
