"""falcon-mamba-7b — attention-free Mamba1 SSM.

[arXiv:2410.05355; unverified]  64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16, expand=2 (d_inner=8192), d_conv=4, dt_rank=256.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2),
        fsdp=True,
        source="arXiv:2410.05355; unverified",
    )
)
