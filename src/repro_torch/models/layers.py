"""Core layers (port of ``src/repro/models/layers.py``): RMSNorm and
LayerNorm, RoPE, GQA self-attention (causal or not; train/prefill/decode),
decoder→encoder cross-attention, the swiglu and gelu MLPs.

Self-attention has three paths:
  * einsum attention (plain torch) for seq <= FLASH_THRESHOLD and all decode;
  * above it, while autograd records, and for causal attention in train
    mode, the chunked online-softmax twin ``_flash_attention_qchunked``
    (plain torch, each KV-block step rematerialised), which is what the JAX
    model runs there;
  * above it otherwise, the Hopper flash-attention kernel
    (``kernels.ops.flash_attention``), which is forward only: a prefill's
    attention, and the encoder's non-causal attention, which JAX runs in
    train mode inside every prefill.
Above the threshold the JAX package declares the chunked scan's FLOPs
(``attention_scan_flops``); the port declares the same whichever path runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding import current_rules, lac, lac_split, per_shard, split_first, use_rules
from repro_torch.spans import span

FLASH_THRESHOLD = 2048  # einsum attention up to here; chunked twin or kernel above
FLASH_BLOCK_KV = 512
FLASH_BLOCK_Q = 4096  # q-chunk above this Sq (bounds the (Sq, block_kv) logits)
NEG_INF = -1e30


def remat(fn, *args):
    """``fn(*args)``; while autograd records, under ``torch.utils.checkpoint``
    (non-reentrant), so that the backward recomputes what ``fn`` computed
    inside instead of keeping it: the counterpart of ``jax.checkpoint``.
    The recomputation runs under the sharding rules of the forward: on a
    CUDA device the backward runs on autograd's own thread, which does not
    see the caller's context."""
    if torch.is_grad_enabled():
        rules = current_rules()

        def run(*a):
            with use_rules(rules):
                return fn(*a)

        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ------------------------------------------------------------------ norms
def norm_spec(cfg) -> dict:
    d = cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {
            "scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros"),
        }
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm when ``p`` has a bias, else RMSNorm; in f32, keeping x's
    dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


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
def attention_spec(cfg, cross: bool = False) -> dict:
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
    if cfg.qk_norm and not cross:
        spec["qnorm"] = head_norm_spec(cfg)
        spec["knorm"] = head_norm_spec(cfg)
    return spec


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) · w (D, KV, …) → (B,S,KV, …), as one flat product
    (B,S,KV·…) placed with KV as its logical axis before it is unflattened:
    over DTensors a product may otherwise shard the flat dim in a way that
    does not split back into (KV, …). A DTensor weight whose q groups are
    split and KV heads not is flattened groups first (``split_first``)."""
    order = split_first(w, (1, 2)) if w.dim() == 4 else None
    if order == (2, 1):
        w = w.permute(0, 2, 1, 3)
    out = x @ w.reshape(w.shape[0], -1)
    out = lac_split(out, w.shape[1], "batch", "seq",
                    "q_per_kv" if order == (2, 1) else "kv_heads")
    out = out.reshape(tuple(x.shape[:2]) + tuple(w.shape[1:]))
    return out.permute(0, 1, 3, 2, 4) if order == (2, 1) else out


def _heads_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Σ over (KV, G, D) of out (B,S,KV,G,D) · wo (KV,G,D,M) → (B,S,M). On
    DTensors that split a head dim, one flat product with the split dim
    major: ``einsum`` flattens (D, KV, G), which makes the split a strided
    shard (``split_first``). Elsewhere the ``einsum`` itself, whose sums a
    flat product does not repeat bit for bit."""
    order = split_first(out, (2, 3))
    if order is None:
        return torch.einsum("bskgd,kgdm->bsm", out, wo)
    B, S = out.shape[:2]
    o = out.permute(0, 1, *order, 4).reshape(B, S, -1)
    return o @ wo.permute(*(d - 2 for d in order), 2, 3).reshape(-1, wo.shape[-1])


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


def _pick_block(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (block-size fallback)."""
    if n % want == 0:
        return want
    for b in range(want, 0, -1):
        if n % b == 0:
            return b
    return n


def _kv_block_step(m, l, acc, qg, kc, vc, qpos, kpos, causal, softcap):
    """One online-softmax step over a KV block: (m, l, acc) (B,KV,G,Sq[,D])
    in f32 → the same after the keys ``kc`` at positions ``kpos``."""
    lg = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float()
    lg = _softcap(lg * (1.0 / math.sqrt(qg.shape[-1])), softcap)
    if causal:
        lg = lg.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    mnew = torch.maximum(m, lg.amax(-1))
    p = torch.exp(lg - mnew[..., None])
    corr = torch.exp(m - mnew)
    lnew = l * corr + p.sum(-1)
    accn = acc * corr[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).float()
    return mnew, lnew, accn


def _flash_attention_chunked(qg, k, v, *, causal, softcap, block_kv=FLASH_BLOCK_KV,
                             q_offset=0):
    """Online softmax over KV blocks (port of ``_flash_attention_jnp``); each
    block step rematerialised, so the backward keeps no block's f32 logits.
    qg (B,Sq,KV,G,D) at positions ``q_offset…``, k/v (B,Sk,KV,D)."""
    B, Sq, KV, G, D = qg.shape
    Sk = k.shape[1]
    block_kv = _pick_block(Sk, block_kv)
    qpos = q_offset + torch.arange(Sq, device=qg.device)
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=qg.device)
    for s0 in range(0, Sk, block_kv):
        kpos = s0 + torch.arange(block_kv, device=qg.device)
        m, l, acc = remat(_kv_block_step, m, l, acc, qg, k[:, s0:s0 + block_kv],
                          v[:, s0:s0 + block_kv], qpos, kpos, causal, softcap)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)  # (B,Sq,KV,G,D)


def _flash_attention_qchunked(qg, k, v, *, causal, softcap, block_q=FLASH_BLOCK_Q,
                              block_kv=FLASH_BLOCK_KV):
    """Double-chunked flash twin: q blocks of ``block_q`` rows bound the
    logits working set to (block_q, block_kv) regardless of Sq. Plain,
    differentiable torch: the attention of the train path."""
    Sq = qg.shape[1]
    if Sq <= block_q:
        return _flash_attention_chunked(qg, k, v, causal=causal, softcap=softcap,
                                        block_kv=block_kv)
    block_q = _pick_block(Sq, block_q)
    return torch.cat([
        _flash_attention_chunked(qg[:, q0:q0 + block_q], k, v, causal=causal,
                                 softcap=softcap, block_kv=block_kv, q_offset=q0)
        for q0 in range(0, Sq, block_q)], dim=1)


# logical axes of attention's q (B,S,KV,G,D) and k, v (B,S,KV,D)
_Q_AXES, _KV_AXES = ("batch", None, "kv_heads", "q_per_kv", None), ("batch", None, "kv_heads", None)


def _per_shard(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, an attention without a cache. On DTensors placed
    by the q/k/v constraints (sharded over batch, kv heads or q groups,
    never over a sequence or head_dim) attention is independent per shard,
    so it runs on each device's shards (``per_shard``), with its output at
    q's placements, forward and backward without a collective; K/V
    replicated where q's groups are split get a partial-sum gradient.
    DTensor's own propagation would merge sharded dims inside its einsums
    and gather them again."""
    return per_shard(lambda a, b, c: fn(a, b, c, **kw), (q, k, v),
                     (_Q_AXES, _KV_AXES, _KV_AXES), (_Q_AXES,))


def _write_slot(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """buf[b, idx[b]] = val[b] in place: buf (B,L,...), val (B,...)."""
    from torch.distributed.tensor import DTensor

    if isinstance(buf, DTensor):
        # DTensor has no in-place index_put (none at all in some releases,
        # none on a sharded cache in others): every shard writes through a
        # mask of its own positions, as a sharded dynamic_update_slice runs
        hit = torch.arange(buf.shape[1], device=buf.device)[None, :] == idx[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        buf.copy_(torch.where(hit, val[:, None], buf))
        return
    buf[torch.arange(buf.shape[0], device=buf.device), idx.long()] = val


def attention_scan_flops(B, Sq, Sk, H, D, causal: bool) -> float:
    """Analytic FLOPs of the chunked-attention scan (QK^T + PV), which the
    JAX package declares for its cost-analysis correction. Causal halves
    the effective area."""
    area = Sq * Sk * (0.5 if causal else 1.0)
    return 4.0 * B * H * area * D


def apply_attention(
    p: dict,
    cfg,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    kv_src: Optional[torch.Tensor] = None,  # cross-attention source
    cache: Optional[dict] = None,  # {"k","v","len"} decode cache
    mode: str = "train",
    max_len: Optional[int] = None,  # prefill: KV-buffer headroom (>= S)
):
    """Returns (out, new_cache, scan_flops). Decode writes the new
    key/value into the cache buffers in place (the JAX version returns
    updated copies)."""
    B, S, _ = x.shape
    with span("attention.qkv"):
        q = _project(x, p["wq"].to(x.dtype))  # (B,S,KV,G,hd)
        src = x if kv_src is None else kv_src
        k = _project(src, p["wk"].to(x.dtype))  # (B,Sk,KV,hd)
        v = _project(src, p["wv"].to(x.dtype))
        if "qnorm" in p:
            q = apply_head_norm(p["qnorm"], q)
            k = apply_head_norm(p["knorm"], k)
    if kv_src is None and cfg.rotary_pct > 0:  # self-attention: RoPE
        with span("attention.rope"):
            cos, sin = rope_freqs(cfg, positions)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    # a decode cache holds its heads whole (its sequence takes the model
    # axis): a step's q, k and v, a few bytes a row, are placed to match,
    # where split heads would flatten with the batch into a strided shard
    heads = (None, None) if mode == "decode" else ("kv_heads", "q_per_kv")
    q = lac(q, "batch", None, *heads, None)
    k = lac(k, "batch", None, heads[0], None)
    v = lac(v, "batch", None, heads[0], None)

    new_cache = None
    scan_flops = 0.0
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token per sequence and a cache")
        idx = cache["len"]  # (B,) current lengths
        kc, vc = cache["k"], cache["v"]
        with span("attention.cache"):
            _write_slot(kc, idx, k[:, 0])
            _write_slot(vc, idx, v[:, 0])
            new_cache = {"k": kc, "v": vc, "len": idx + 1}
        with span("attention.core"):
            out = _einsum_attention(
                q, kc, vc, causal=False, softcap=cfg.attn_logit_softcap, kv_len=idx + 1
            )
    else:
        if mode == "prefill":
            with span("attention.cache"):
                L = k.shape[1] + (max_len or S) - S
                kc = k.new_zeros((B, L) + tuple(k.shape[2:]))
                vc = v.new_zeros((B, L) + tuple(v.shape[2:]))
                kc[:, :k.shape[1]] = k
                vc[:, :v.shape[1]] = v
                new_cache = {
                    "k": kc,
                    "v": vc,
                    "len": torch.full((B,), S, dtype=torch.int32, device=x.device),
                }
        records = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                               or v.requires_grad)
        with span("attention.core"):
            if S > FLASH_THRESHOLD and kv_src is None:
                # the twin where autograd records, and for a decoder's
                # train-mode forward (causal) even where it does not;
                # non-causal self-attention is the encoder's, which JAX runs
                # in train mode inside every prefill: there the forward-only
                # kernel serves it
                if records or (mode == "train" and causal):
                    out = _per_shard(_flash_attention_qchunked, q, k, v, causal=causal,
                                     softcap=cfg.attn_logit_softcap)
                else:
                    out = ops.flash_attention(q, k, v, causal=causal,
                                              softcap=cfg.attn_logit_softcap)
                scan_flops = attention_scan_flops(B, S, S, cfg.num_heads, cfg.head_dim, causal)
            else:
                out = _per_shard(_einsum_attention, q, k, v, causal=causal,
                                 softcap=cfg.attn_logit_softcap)
    with span("attention.out"):
        out = lac(out, "batch", None, "kv_heads", "q_per_kv", None)
        y = _heads_out(out, p["wo"].to(x.dtype))
    return y, new_cache, scan_flops


def apply_cross_attention(p, cfg, x, enc_out, *, cache=None, mode="train"):
    """Decoder→encoder cross-attention (no RoPE, non-causal). Returns (out,
    new_cache).

    prefill: computes K/V from ``enc_out`` and returns them as the cache.
    decode: reuses the cached K/V and passes the cache through; nothing
    writes into it.
    """
    q = lac(_project(x, p["wq"].to(x.dtype)), "batch", None, "kv_heads", "q_per_kv", None)
    if mode == "decode" and cache is not None:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        if enc_out is None:
            raise ValueError("cross-attention needs enc_out outside decode")
        # the encoder's output whole along its sequence, as a sublayer input
        enc_out = lac(enc_out, "batch", "seq", None)
        k = _project(enc_out, p["wk"].to(x.dtype))
        v = _project(enc_out, p["wv"].to(x.dtype))
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    k = lac(k, "batch", None, "kv_heads", None)
    v = lac(v, "batch", None, "kv_heads", None)
    out = _per_shard(_einsum_attention, q, k, v, causal=False, softcap=0.0)
    y = _heads_out(out, p["wo"].to(x.dtype))
    return y, new_cache


# ------------------------------------------------------------------- MLPs
def mlp_spec(cfg, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "wi": ParamSpec((d, f), ("embed", "mlp")),
            "wg": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (silu(x·wg) ⊙ x·wi)·wo, or gelu(x·wi)·wo without ``wg``."""
    h = x @ p["wi"].to(x.dtype)
    h = F.silu(x @ p["wg"].to(x.dtype)) * h if "wg" in p else gelu(h)
    h = lac(h, "batch", "seq", "mlp")
    return h @ p["wo"].to(x.dtype)
