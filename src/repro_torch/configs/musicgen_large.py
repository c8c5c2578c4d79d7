"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32 == MHA) d_ff=8192
vocab=2048.  The EnCodec frontend is a STUB: the backbone consumes codebook
token ids directly (4 codebooks, embeddings summed; 4 parallel LM heads).
MusicGen uses a standard (non-gated) GELU MLP.
"""
from repro_torch.configs.base import AudioConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_type="gelu",
        audio=AudioConfig(n_codebooks=4),
        fsdp=True,
        source="arXiv:2306.05284; hf",
    )
)
