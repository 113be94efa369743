"""Model configuration dataclasses + arch registry (port of
``src/repro/models/config.py`` with torch dtypes)."""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # the port's own, past the JAX package's fields: dropless dispatch (no
    # capacity: every (token, k) pair is computed), and a shared SwiGLU
    # expert of this width beside the routed ones (0: none)
    dropless: bool = False
    shared_d_ff: int = 0


@dataclass(frozen=True)
class MambaConfig:
    """Mamba block as the Mamba-2 / SSD matmul formulation: a scalar decay
    per head, chunked over the sequence."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    conv_bias: bool = False  # a bias after the depthwise conv (the port's own)


@dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4
    slstm_every: int = 4  # every k-th block is sLSTM (rest mLSTM)


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
    # MoE: layer i is MoE iff moe_every > 0 and (i % moe_every == moe_offset)
    moe: Optional[MoEConfig] = None
    moe_every: int = 0
    moe_offset: int = 1
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
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
    # muP scalars (granite 4.0): the embedding times ``embedding_multiplier``,
    # every sublayer's output times ``residual_multiplier`` before its
    # residual add, attention logits times ``attention_multiplier`` (0:
    # 1/sqrt(head_dim)), the logits divided by ``logits_scaling``
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # layer layout knobs (kept for parity with the JAX configs)
    scan_layers: bool = False  # params stacked per period: {"scan": ...}
    remat: str = "block"  # none | block | full (train mode only; block == full)
    sub_quadratic: bool = False

    def __post_init__(self):
        """Also takes ``moe`` and ``mamba`` as dicts of their fields and
        ``block_pattern`` as a list, as a JSON file states them."""
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        for name, kind in (("moe", MoEConfig), ("mamba", MambaConfig)):
            if isinstance(getattr(self, name), dict):
                object.__setattr__(self, name, kind(**getattr(self, name)))
        object.__setattr__(self, "block_pattern", tuple(self.block_pattern))

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

    @property
    def attn_scale(self) -> float:
        """What attention multiplies its q·k logits by."""
        return self.attention_multiplier or 1.0 / math.sqrt(self.head_dim)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


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
