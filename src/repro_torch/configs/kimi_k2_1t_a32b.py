"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8).

[arXiv:2501.kimi2; unverified — paper-table spec]  61L d_model=7168 64H
(GQA kv=8) d_ff=2048 (per expert) vocab=163840, MoE 384e top-8.
head_dim 112 (= 7168/64).  ~1.04T total params, ~31B active.
Requires: expert parallelism over the model axis, FSDP over data, 8-bit
optimizer states (see train/).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
        fsdp=True,
        param_dtype="bfloat16",  # 1T fp32 weights cannot fit 512 chips
        source="arXiv:2501.kimi2; unverified",
    )
)
