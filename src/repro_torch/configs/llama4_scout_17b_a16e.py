"""llama4-scout-17b-a16e — MoE with 16 experts, top-1 (switch-style routing).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192),
        fsdp=True,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
)
