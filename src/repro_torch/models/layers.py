"""Core layers (port of ``src/repro/models/layers.py``): norms, RoPE, GQA
attention (train/prefill/decode), the swiglu MLP. The slice ports what
qwen3 uses; other norm and MLP kinds raise ``NotImplementedError``.

Attention has two paths, as in the JAX package:
  * einsum attention (plain torch) for seq <= FLASH_THRESHOLD and all decode;
  * the Hopper flash-attention kernel (``kernels.ops.flash_attention``) for
    self-attention above it, where the JAX model runs its jnp twin
    ``_flash_attention_qchunked``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec

FLASH_THRESHOLD = 2048  # einsum attention up to here; flash kernel above
NEG_INF = -1e30


# ------------------------------------------------------------------ norms
def norm_spec(cfg) -> dict:
    if cfg.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm_kind {cfg.norm_kind!r} is not ported yet")
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, keeping x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


def head_norm_spec(cfg) -> dict:  # per-head qk-norm (qwen3 style)
    return {"scale": ParamSpec((cfg.head_dim,), ("head_dim",), init="ones")}


def apply_head_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_freqs(cfg, positions: torch.Tensor):
    """positions (…,) int → cos/sin (…, rot_dim/2) float32."""
    rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,...,D); cos/sin (B,S,R/2) or (S,R/2). Rotates the first R dims
    (interleaved pairs), in f32, keeping x's dtype."""
    r2 = cos.shape[-1]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    shape = tuple(cos.shape[:2]) + (1,) * (x.dim() - 3) + (r2,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    xr, xp = x[..., : 2 * r2], x[..., 2 * r2:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = (x1 * cos - x2 * sin).to(x.dtype)
    o2 = (x2 * cos + x1 * sin).to(x.dtype)
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], -1) if xp.shape[-1] else out


# -------------------------------------------------------------- attention
# Q projections live in the GQA (KV, G) layout — wq (d, KV, G, hd) — as in
# the JAX package, so the flash kernel reads q (B,S,KV,G,D) in place.
def attention_spec(cfg) -> dict:
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    g = cfg.q_per_kv
    spec = {
        "wq": ParamSpec(
            (d, kv, g, hd), ("embed", "kv_heads", "q_per_kv", "head_dim"),
            fan_in_axis=0,
        ),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in_axis=0),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in_axis=0),
        "wo": ParamSpec(
            (kv, g, hd, d), ("kv_heads", "q_per_kv", "head_dim", "embed"),
            fan_in_axis=-2,
        ),
    }
    if cfg.qk_norm:
        spec["qnorm"] = head_norm_spec(cfg)
        spec["knorm"] = head_norm_spec(cfg)
    return spec


def _softcap(logits, cap):
    return torch.tanh(logits / cap) * cap if cap else logits


def _einsum_attention(qg, k, v, *, causal, softcap, kv_len=None):
    """qg (B,Sq,KV,G,D), k/v (B,Sk,KV,D). Returns (B,Sq,KV,G,D)."""
    B, Sq, KV, G, D = qg.shape
    Sk = k.shape[1]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = _softcap(logits * (1.0 / math.sqrt(D)), softcap)
    mask = None
    if causal:
        mask = (torch.arange(Sq, device=qg.device)[:, None]
                >= torch.arange(Sk, device=qg.device)[None, :])
    if kv_len is not None:  # decode: valid cache prefix only
        valid = torch.arange(Sk, device=qg.device)[None, :] < kv_len[:, None]
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def apply_attention(
    p: dict,
    cfg,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,  # {"k","v","len"} decode cache
    mode: str = "train",
    max_len: Optional[int] = None,  # prefill: KV-buffer headroom (>= S)
):
    """Causal self-attention. Returns (out, new_cache). Decode writes the
    new key/value into the cache buffers in place (the JAX version returns
    updated copies)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"].to(x.dtype))  # (B,S,KV,G,hd)
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"].to(x.dtype))  # (B,S,KV,hd)
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"].to(x.dtype))
    if "qnorm" in p:
        q = apply_head_norm(p["qnorm"], q)
        k = apply_head_norm(p["knorm"], k)
    if cfg.rotary_pct > 0:
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token per sequence and a cache")
        idx = cache["len"]  # (B,) current lengths
        rows = torch.arange(B, device=x.device)
        kc, vc = cache["k"], cache["v"]
        kc[rows, idx.long()] = k[:, 0]
        vc[rows, idx.long()] = v[:, 0]
        new_cache = {"k": kc, "v": vc, "len": idx + 1}
        out = _einsum_attention(
            q, kc, vc, causal=False, softcap=cfg.attn_logit_softcap, kv_len=idx + 1
        )
    else:
        if mode == "prefill":
            L = max_len or S
            kc = k.new_zeros((B, L) + tuple(k.shape[2:]))
            vc = v.new_zeros((B, L) + tuple(v.shape[2:]))
            kc[:, :S] = k
            vc[:, :S] = v
            new_cache = {
                "k": kc,
                "v": vc,
                "len": torch.full((B,), S, dtype=torch.int32, device=x.device),
            }
        if S > FLASH_THRESHOLD:
            out = ops.flash_attention(q, k, v, causal=True,
                                      softcap=cfg.attn_logit_softcap)
        else:
            out = _einsum_attention(q, k, v, causal=True,
                                    softcap=cfg.attn_logit_softcap)
    y = torch.einsum("bskgd,kgdm->bsm", out, p["wo"].to(x.dtype))
    return y, new_cache


# ------------------------------------------------------------------- MLPs
def mlp_spec(cfg) -> dict:
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def apply_mlp(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x·wg) ⊙ x·wi)·wo."""
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
