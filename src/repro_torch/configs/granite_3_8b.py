"""granite-3-8b — IBM Granite 3.0 dense GQA transformer.

[hf:ibm-granite/granite-3.0-2b-base family; hf]  40L d_model=4096 32H
(GQA kv=8) d_ff=12800 vocab=49155, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        fsdp=True,
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
    )
)
