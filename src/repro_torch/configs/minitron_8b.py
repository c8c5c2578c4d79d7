"""minitron-8b — width/depth-pruned Nemotron-4.

[arXiv:2407.14679; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000.  Nemotron family uses squared-ReLU (non-gated) MLP.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        mlp_type="relu2",
        fsdp=True,
        source="arXiv:2407.14679; hf",
    )
)
