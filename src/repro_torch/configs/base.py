"""Config system: model architecture configs + input-shape configs + registry.

Every assigned architecture is a frozen dataclass instance registered under its
arch id; shapes are the 4 assigned LM shape cells.  Frozen/hashable so configs
can be closed over by jitted functions as static data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# --------------------------------------------------------------------------- #
# Sub-configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    router_dtype: str = "float32"
    # capacity factor used for sizing dense one-hot dispatch (GSPMD-friendly)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    version: int  # 1 = Mamba1 (selective scan), 2 = Mamba2 (SSD)
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # mamba2 only: SSD head dim
    chunk: int = 256  # mamba2 SSD chunk length
    dt_rank: int = 0  # mamba1: rank of dt projection; 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class VisionConfig:
    cross_attn_every: int  # a cross-attn layer every k-th layer
    n_patches: int = 1601  # precomputed patch embeddings (frontend stub)
    d_vision: int = 1280


@dataclass(frozen=True)
class AudioConfig:
    n_codebooks: int = 4  # EnCodec codebooks; embeddings summed (frontend stub)


@dataclass(frozen=True)
class HybridConfig:
    attn_every: int  # shared attention block applied after every k SSM layers
    shared_attn_mlp_ff: int = 8192


# --------------------------------------------------------------------------- #
# Model config
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"  # swiglu | gelu | relu2
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    hybrid: Optional[HybridConfig] = None
    # runtime knobs (overridable per launch)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # weight storage; "bfloat16" for 1T-scale
    remat: str = "full"  # full | dots | none
    fsdp: bool = False  # ZeRO-3 style param sharding over the data axis
    use_flash: bool = True  # use the Pallas flash-attention kernel path
    source: str = ""  # provenance note

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def dt_rank(self) -> int:
        if not self.ssm:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def attention_free(self) -> bool:
        return self.family == "ssm"

    def subquadratic(self) -> bool:
        """Can this arch serve a 500k context without a dense KV cache?"""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------ param count
    def param_count(self) -> int:
        """Exact parameter count of the JAX implementation (see models/)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d  # token embedding
        if not self.tie_embeddings:
            total += V * d  # lm head
        if self.audio:
            total += (self.audio.n_codebooks - 1) * V * d  # extra codebook emb
            total += (self.audio.n_codebooks - 1) * V * d  # extra heads
        if self.vision:
            total += self.vision.d_vision * d  # patch-embedding projection
        per_layer = self._per_layer_params()
        total += per_layer
        total += d  # final norm
        return total

    def _per_layer_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        hd = self.hd
        n_attn = 0
        attn_layer = (
            d * (self.n_heads * hd)  # Wq
            + 2 * d * (self.n_kv_heads * hd)  # Wk, Wv
            + (self.n_heads * hd) * d  # Wo
            + (2 * d)  # norms (pre-attn + pre-mlp)
        )
        if self.qkv_bias:
            attn_layer += self.n_heads * hd + 2 * self.n_kv_heads * hd
        if self.family in ("dense", "vlm", "audio", "moe"):
            n_attn = self.n_layers
        mlp = {
            "swiglu": 3 * d * ff,
            "gelu": 2 * d * ff,
            "relu2": 2 * d * ff,
        }[self.mlp_type]
        total = 0
        if self.family in ("dense", "vlm", "audio"):
            total = self.n_layers * (attn_layer + mlp)
            if self.vision:
                n_cross = self.n_layers // self.vision.cross_attn_every
                # cross layers reuse the attn+mlp shape (already counted in
                # n_layers) and add their tanh gates (attn + mlp, scalars)
                total += n_cross * 2
        elif self.family == "moe":
            e = self.moe
            expert = 3 * d * e.d_ff_expert  # swiglu experts
            total = self.n_layers * (
                attn_layer + e.n_experts * expert + d * e.n_experts  # router
            )
        elif self.family == "ssm":
            di, s = self.d_inner, self.ssm
            layer = (
                d * 2 * di  # in_proj (x, z)
                + di * s.d_conv + di  # depthwise conv + bias
                + di * (self.dt_rank + 2 * s.d_state)  # x -> (dt, B, C)
                + self.dt_rank * di + di  # dt_proj + dt_bias
                + di * s.d_state  # A_log
                + di  # D
                + di * d  # out_proj
                + d  # norm
            )
            total = self.n_layers * layer
        elif self.family == "hybrid":
            # Mamba2 with n_groups=1 (B, C shared across heads — the zamba2/
            # mamba2 default), matching models/ssm_models.mamba2_defs
            di, s = self.d_inner, self.ssm
            nh = di // s.head_dim
            N = s.d_state
            m2_layer = (
                d * (2 * di + 2 * N + nh)  # in_proj: x, z, B, C, dt
                + (di + 2 * N) * s.d_conv + (di + 2 * N)  # conv over x,B,C + bias
                + nh  # A_log
                + nh  # dt_bias
                + nh  # D
                + di  # gated norm
                + di * d  # out_proj
                + d  # norm
            )
            total = self.n_layers * m2_layer
            # one SHARED attention block (concat input 2d; out proj to d)
            h = self.hybrid
            shared = (
                (2 * d) * (self.n_heads * self.hd)  # wq
                + 2 * (2 * d) * (self.n_kv_heads * self.hd)  # wk, wv
                + (self.n_heads * self.hd) * d  # wo
                + 3 * d * h.shared_attn_mlp_ff  # swiglu mlp
                + (2 * d) + d  # ln1 (2d) + ln2 (d)
            )
            total += shared
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        e = self.moe
        d = self.d_model
        expert = 3 * d * e.d_ff_expert
        inactive = self.n_layers * (e.n_experts - e.top_k) * expert
        return self.param_count() - inactive

    # -------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            remat="none",
            fsdp=False,
            use_flash=False,
        )
        if self.family == "hybrid":
            kw["n_kv_heads"] = 4  # MHA in zamba2
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=8, head_dim=16, chunk=16, dt_rank=8)
        if self.vision:
            kw["vision"] = replace(self.vision, cross_attn_every=2, n_patches=16, d_vision=32)
        if self.audio:
            kw["audio"] = replace(self.audio, n_codebooks=2)
        if self.hybrid:
            kw["hybrid"] = replace(self.hybrid, attn_every=2, shared_attn_mlp_ff=128)
        return replace(self, **kw)


# --------------------------------------------------------------------------- #
# Shape cells
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a 'skip:<reason>' marker for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic():
        return "skip:full-attention arch; 500k decode needs sub-quadratic attention (DESIGN.md)"
    return "run"


def all_cells() -> list[tuple[str, str, str]]:
    """[(arch, shape, status)] for the full 40-cell grid."""
    out = []
    for a in all_archs():
        cfg = get_config(a)
        for s in SHAPES.values():
            out.append((a, s.name, cell_status(cfg, s)))
    return out
