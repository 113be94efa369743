"""Block/stack assembly (port of ``src/repro/models/transformer.py``).

Layers are grouped into *periods* (the LCM of the block pattern and the
MoE interleave). Both parameter layouts of the JAX package are accepted:
``{"scan": period}`` with every leaf stacked over the periods on a leading
axis, and ``{"unroll": (layer, …)}``; caches follow the same layout. The
stacked layout runs as a Python loop over the periods.

This slice ports attention blocks with a dense MLP. MoE, mamba, xLSTM,
cross-attention and encoder–decoder stacks raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.schema import ParamSpec
from repro_torch.tree import tree_leaves, tree_map


def _unsupported(what: str):
    return NotImplementedError(f"{what} is not ported yet (attention blocks "
                               "with a dense MLP only)")


# ----------------------------------------------------------------- layout
def period_layout(cfg) -> List[Tuple[str, bool]]:
    """[(kind, is_moe)] for one period of the layer layout."""
    pat = len(cfg.block_pattern)
    moe_p = cfg.moe_every if (cfg.moe is not None and cfg.moe_every > 0) else 1
    period = math.lcm(pat, moe_p)
    return [(cfg.block_kind(i), cfg.is_moe_layer(i)) for i in range(period)]


def n_periods(cfg) -> int:
    p = len(period_layout(cfg))
    if cfg.num_layers % p:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by period {p}")
    return cfg.num_layers // p


# ------------------------------------------------------------ layer specs
def layer_spec(cfg, kind: str, is_moe: bool) -> dict:
    if kind != "attn":
        raise _unsupported(f"block kind {kind!r}")
    if is_moe:
        raise _unsupported("MoE")
    spec: Dict[str, Any] = {"ln1": L.norm_spec(cfg), "attn": L.attention_spec(cfg)}
    if cfg.d_ff > 0:
        spec["ln2"] = L.norm_spec(cfg)
        spec["mlp"] = L.mlp_spec(cfg)
    return spec


def _stack_spec(spec_tree, n: int):
    return tree_map(
        lambda s: ParamSpec(
            (n,) + s.shape,
            ("layers",) + s.axes,
            init=s.init,
            scale=s.scale,
            fan_in_axis=(s.fan_in_axis - 1 if s.fan_in_axis >= 0 else s.fan_in_axis),
            dtype=s.dtype,
        ),
        spec_tree,
        is_leaf=lambda x: isinstance(x, ParamSpec),
    )


def stack_spec(cfg) -> dict:
    """Spec for a full stack. scan_layers → one period spec, leaves stacked
    over n_periods; else a tuple of per-layer specs."""
    layout = period_layout(cfg)
    n = n_periods(cfg)
    period = tuple(layer_spec(cfg, k, m) for k, m in layout)
    if cfg.scan_layers:
        return {"scan": _stack_spec(period, n)} if n > 1 else {"unroll": period}
    return {"unroll": period * n}


# --------------------------------------------------------- cache plumbing
def layer_cache_spec(cfg, kind: str, batch: int, max_len: int) -> dict:
    """Decode-cache (shape, dtype) leaves for one layer."""
    if kind != "attn":
        raise _unsupported(f"block kind {kind!r}")
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "kv": {
            "k": ((batch, max_len, kv, hd), cfg.compute_dtype),
            "v": ((batch, max_len, kv, hd), cfg.compute_dtype),
            "len": ((batch,), torch.int32),
        }
    }


def stack_cache_spec(cfg, batch: int, max_len: int):
    layout = period_layout(cfg)
    n = n_periods(cfg)
    period = tuple(layer_cache_spec(cfg, k, batch, max_len) for k, _ in layout)
    is_sd = _is_shape_dtype
    if cfg.scan_layers and n > 1:
        return {"scan": tree_map(lambda s: ((n,) + s[0], s[1]), period, is_leaf=is_sd)}
    return {"unroll": period * n}


def _is_shape_dtype(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], torch.dtype))


# ------------------------------------------------------------- layer body
def apply_layer(p: dict, cfg, kind: str, x: torch.Tensor, *, positions,
                cache: Optional[dict], mode: str, max_len: Optional[int] = None):
    """Pre-norm residual layer. Returns (x, new_cache)."""
    if kind != "attn":
        raise _unsupported(f"block kind {kind!r}")
    h = L.apply_norm(p["ln1"], x)
    out, kvc = L.apply_attention(
        p["attn"], cfg, h, positions=positions,
        cache=cache["kv"] if cache else None, mode=mode, max_len=max_len,
    )
    x = x + out
    new_cache = {"kv": kvc} if kvc is not None else None
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["ln2"], x))
    return x, new_cache


def _apply_period(pp, cfg, layout, x, *, positions, caches, mode, max_len):
    """One period of layers. caches: tuple aligned with layout (or None)."""
    new_caches = []
    for i, (kind, _) in enumerate(layout):
        c = caches[i] if caches is not None else None
        x, nc = apply_layer(pp[i], cfg, kind, x, positions=positions, cache=c,
                            mode=mode, max_len=max_len)
        new_caches.append(nc)
    return x, tuple(new_caches)


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    if dst.data_ptr() != src.data_ptr():  # in-place updates alias already
        dst.copy_(src)
    return dst


def apply_stack(params: dict, cfg, x: torch.Tensor, *, positions, caches=None,
                mode: str = "train", max_len: Optional[int] = None):
    """Run a stack. Returns (x, new_caches); caches mirror the
    ``stack_cache_spec`` layout ({"scan": ...} or {"unroll": ...}). In the
    stacked layout a decode step updates the stacked cache in place."""
    layout = period_layout(cfg)
    want_cache = mode in ("prefill", "decode")
    kw = dict(positions=positions, mode=mode, max_len=max_len)

    if "scan" in params:
        stacked = params["scan"]
        n = tree_leaves(stacked)[0].shape[0]
        pc_stacked = caches["scan"] if caches is not None else None
        per_period = []
        for i in range(n):
            pp = tree_map(lambda a, i=i: a[i], stacked)
            pc = tree_map(lambda a, i=i: a[i], pc_stacked) if pc_stacked else None
            x, ncs = _apply_period(pp, cfg, layout, x, caches=pc, **kw)
            if pc is not None:
                tree_map(_write_back, pc, ncs)
            elif want_cache:
                per_period.append(ncs)
        if not want_cache:
            return x, None
        if pc_stacked is not None:
            return x, {"scan": pc_stacked}
        return x, {"scan": tree_map(lambda *ls: torch.stack(ls), *per_period)}

    per_layers = params["unroll"]
    n = len(per_layers) // len(layout)
    ncs_all: List[Any] = []
    for pi in range(n):
        pp = per_layers[pi * len(layout): (pi + 1) * len(layout)]
        pc = (caches["unroll"][pi * len(layout): (pi + 1) * len(layout)]
              if caches is not None else None)
        x, ncs = _apply_period(tuple(pp), cfg, layout, x,
                               caches=tuple(pc) if pc else None, **kw)
        ncs_all.extend(ncs)
    return x, ({"unroll": tuple(ncs_all)} if want_cache else None)
