"""llama-3.2-vision-11b — text backbone with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256.  Every 5th layer is a cross-attention
layer attending to precomputed vision-patch embeddings (the vision tower is
a STUB frontend per the assignment: input_specs() provides patch embeddings
of shape [batch, 1601, 1280]).
"""
from repro_torch.configs.base import ModelConfig, VisionConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        vision=VisionConfig(cross_attn_every=5, n_patches=1601, d_vision=1280),
        fsdp=True,
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )
)
