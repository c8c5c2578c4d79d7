"""zamba2-1.2b — hybrid: Mamba2 backbone + one SHARED attention block.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (GQA kv=32 == MHA) d_ff=8192
vocab=32000, ssm_state=64.  38 Mamba2 (SSD) layers; a single shared-weight
attention+MLP block is applied after every 6 SSM layers on
concat(hidden, residual_stream_input) (2*d_model -> d_model projections).
Sub-quadratic backbone: runs the long_500k cell (the shared block's KV cache
at 500k is the documented cost; see DESIGN.md).
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        hybrid=HybridConfig(attn_every=6, shared_attn_mlp_ff=8192),
        fsdp=True,
        source="arXiv:2411.15242; hf",
    )
)
