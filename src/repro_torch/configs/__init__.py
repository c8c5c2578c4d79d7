"""Architecture config registry — import side-effect registers all archs."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    all_archs,
    all_cells,
    cell_status,
    get_config,
    register,
)

# one module per assigned architecture (+ the paper's own workload configs live
# in repro.workloads)
from repro_torch.configs import (  # noqa: F401
    falcon_mamba_7b,
    granite_3_8b,
    kimi_k2_1t_a32b,
    llama4_scout_17b_a16e,
    llama_3_2_vision_11b,
    minitron_8b,
    musicgen_large,
    phi4_mini_3_8b,
    qwen2_5_32b,
    zamba2_1_2b,
)

ALL_ARCH_IDS = [
    "musicgen-large",
    "minitron-8b",
    "qwen2.5-32b",
    "granite-3-8b",
    "phi4-mini-3.8b",
    "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e",
    "falcon-mamba-7b",
    "llama-3.2-vision-11b",
    "zamba2-1.2b",
]
