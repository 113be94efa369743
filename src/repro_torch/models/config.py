"""Model configuration dataclasses + arch registry (port of
``src/repro/models/config.py`` with torch dtypes)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    # block layout: pattern cycled over layers. entries: attn | mamba | slstm | mlstm
    block_pattern: Tuple[str, ...] = ("attn",)
    # MoE: layer i is MoE iff moe_every > 0 and (i % moe_every == moe_offset).
    # The MoE / mamba / xLSTM sub-configs come with their slices; only their
    # presence is read here (the stack raises NotImplementedError).
    moe: Optional[Any] = None
    moe_every: int = 0
    moe_offset: int = 1
    mamba: Optional[Any] = None
    xlstm: Optional[Any] = None
    # attention details
    mlp_kind: str = "swiglu"  # swiglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 1e4
    rotary_pct: float = 1.0
    attn_logit_softcap: float = 0.0  # grok-style tanh softcap, 0 = off
    tie_embeddings: bool = False
    # encoder-decoder
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # modality frontend stub: none | audio | vision (precomputed embeddings input)
    frontend: str = "none"
    frontend_seq: int = 0
    max_seq_len: int = 131072
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # layer layout knobs (kept for parity with the JAX configs)
    scan_layers: bool = False  # params stacked per period: {"scan": ...}
    remat: str = "block"  # none | block | full (train only; no train yet)
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        return self.moe is not None and self.moe_every > 0 and (
            layer % self.moe_every == self.moe_offset % self.moe_every
        )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------- registry
_REGISTRY: dict = {}


def register(name: str, fn):
    _REGISTRY[name] = fn


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg.with_(**overrides) if overrides else cfg


def list_archs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
