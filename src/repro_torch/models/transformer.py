"""Token embedding and the LM head (the pieces of the reference's transformer
module that the SSM families use; no audio codebooks)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens: [B, S] -> [B, S, d] in ``dtype``."""
    return params["embed"][0][tokens].to(dtype)


def lm_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> [B, S, V] fp32 logits."""
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", hn, params["lm_head"][0].to(hn.dtype)).float()
