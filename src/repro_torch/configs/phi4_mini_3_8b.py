"""phi4-mini-3.8b — dense GQA transformer (RoPE, SwiGLU).

[arXiv:2412.08905; hf]  32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        fsdp=True,
        source="arXiv:2412.08905; hf",
    )
)
