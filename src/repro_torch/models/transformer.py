"""Block/stack assembly (port of ``src/repro/models/transformer.py``).

Layers are grouped into *periods* (the LCM of the block pattern and the
MoE interleave). Both parameter layouts of the JAX package are accepted:
``{"scan": period}`` with every leaf stacked over the periods on a leading
axis, and ``{"unroll": (layer, …)}``; caches follow the same layout. The
stacked layout runs as a Python loop over the periods, each of which
declares its own scan FLOPs (``models.accounting``), so no ``scan_scope``
multiplies them.

In train mode with ``cfg.remat != "none"`` each period runs under
``torch.utils.checkpoint`` (``layers.remat``), as JAX wraps it in
``jax.checkpoint``. JAX's ``"block"`` policy saves only values named
``remat_save``, and no value of the model carries that name, so it saves
nothing inside a period: ``"block"`` and ``"full"`` are the same here.

Blocks are attention, mamba, mLSTM or sLSTM, each followed by a dense MLP
or an MoE sublayer where the config has one; the MoE aux losses are summed
over the layers and periods. Each sublayer's output is scaled by
``residual_multiplier`` before its residual add where the config sets
one. An encoder–decoder's decoder layers add a
cross-attention sublayer (``lnx``, ``cross``) over the encoder's output,
and their cache a ``cross`` half of the encoder's length beside the
self-attention ``kv``. JAX's ``apply_stack`` also takes ``decoder=``, which
it does not use (a layer has a cross sublayer when its params do); the
port leaves it out.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.accounting import add_scan_flops
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding import is_axes, lac, lac_grad
from repro_torch.spans import span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ----------------------------------------------------------------- layout
def period_layout(cfg) -> List[Tuple[str, bool]]:
    """[(kind, is_moe)] for one period of the layer layout."""
    pat = len(cfg.block_pattern)
    moe_p = cfg.moe_every if (cfg.moe is not None and cfg.moe_every > 0) else 1
    period = math.lcm(pat, moe_p)
    return [(cfg.block_kind(i), cfg.is_moe_layer(i)) for i in range(period)]


def n_periods(cfg, num_layers: Optional[int] = None) -> int:
    nl = num_layers if num_layers is not None else cfg.num_layers
    p = len(period_layout(cfg))
    if nl % p:
        raise ValueError(f"num_layers {nl} not divisible by period {p}")
    return nl // p


# ------------------------------------------------------------ layer specs
def layer_spec(cfg, kind: str, is_moe: bool, decoder: bool = False) -> dict:
    spec: Dict[str, Any] = {"ln1": L.norm_spec(cfg)}
    if kind == "attn":
        spec["attn"] = L.attention_spec(cfg)
        if decoder and cfg.encoder_decoder:
            spec["lnx"] = L.norm_spec(cfg)
            spec["cross"] = L.attention_spec(cfg, cross=True)
    elif kind == "mamba":
        spec["mamba"] = S.mamba_spec(cfg)
    elif kind == "mlstm":
        spec["mlstm"] = X.mlstm_spec(cfg)
    elif kind == "slstm":
        spec["slstm"] = X.slstm_spec(cfg)
    else:
        raise ValueError(kind)
    if is_moe:
        spec["ln2"] = L.norm_spec(cfg)
        spec["moe"] = M.moe_spec(cfg)
    elif cfg.d_ff > 0:
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


def stack_spec(cfg, num_layers: Optional[int] = None, decoder: bool = False) -> dict:
    """Spec for a full stack. scan_layers → one period spec, leaves stacked
    over n_periods; else a tuple of per-layer specs."""
    layout = period_layout(cfg)
    n = n_periods(cfg, num_layers)
    period = tuple(layer_spec(cfg, k, m, decoder) for k, m in layout)
    if cfg.scan_layers:
        return {"scan": _stack_spec(period, n)} if n > 1 else {"unroll": period}
    return {"unroll": period * n}


# --------------------------------------------------------- cache plumbing
def layer_cache_spec(cfg, kind: str, batch: int, max_len: int, decoder: bool = False):
    """Decode-cache (shape, dtype) leaves for one layer."""
    if kind == "attn":
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        c = {
            "kv": {
                "k": ((batch, max_len, kv, hd), cfg.compute_dtype),
                "v": ((batch, max_len, kv, hd), cfg.compute_dtype),
                "len": ((batch,), torch.int32),
            }
        }
        if decoder and cfg.encoder_decoder:
            f = cfg.frontend_seq
            c["cross"] = {
                "k": ((batch, f, kv, hd), cfg.compute_dtype),
                "v": ((batch, f, kv, hd), cfg.compute_dtype),
            }
        return c
    if kind == "mamba":
        return S.mamba_cache_spec(cfg, batch)
    if kind == "mlstm":
        return X.mlstm_cache_spec(cfg, batch)
    if kind == "slstm":
        return X.slstm_cache_spec(cfg, batch)
    raise ValueError(kind)


def stack_cache_spec(cfg, batch: int, max_len: int, num_layers: Optional[int] = None,
                     decoder: bool = False):
    layout = period_layout(cfg)
    n = n_periods(cfg, num_layers)
    period = tuple(layer_cache_spec(cfg, k, batch, max_len, decoder) for k, _ in layout)
    is_sd = _is_shape_dtype
    if cfg.scan_layers and n > 1:
        return {"scan": tree_map(lambda s: ((n,) + s[0], s[1]), period, is_leaf=is_sd)}
    return {"unroll": period * n}


def _is_shape_dtype(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], torch.dtype))


def layer_cache_axes(cfg, kind: str, decoder: bool = False):
    """Logical-axis tree mirroring layer_cache_spec (for cache shardings)."""
    if kind == "attn":
        c = {
            "kv": {
                "k": ("cache_batch", "kv_seq", "kv_heads", "head_dim"),
                "v": ("cache_batch", "kv_seq", "kv_heads", "head_dim"),
                "len": ("cache_batch",),
            }
        }
        if decoder and cfg.encoder_decoder:
            c["cross"] = {
                "k": ("cache_batch", None, "kv_heads", "head_dim"),
                "v": ("cache_batch", None, "kv_heads", "head_dim"),
            }
        return c
    if kind == "mamba":
        return {"conv": ("cache_batch", None, None),
                "ssm": ("cache_batch", "inner", None, None)}
    if kind == "mlstm":
        return {
            "conv": ("cache_batch", None, None),
            "mlstm": (
                ("cache_batch", "heads", None, None),
                ("cache_batch", "heads", None),
                ("cache_batch", "heads"),
            ),
        }
    if kind == "slstm":
        return {
            "conv": ("cache_batch", None, None),
            "slstm": tuple(("cache_batch", "heads", None) for _ in range(4)),
        }
    raise ValueError(kind)


def stack_cache_axes(cfg, num_layers: Optional[int] = None, decoder: bool = False):
    layout = period_layout(cfg)
    n = n_periods(cfg, num_layers)
    period = tuple(layer_cache_axes(cfg, k, decoder) for k, _ in layout)
    if cfg.scan_layers and n > 1:
        return {"scan": tree_map(lambda a: ("layers",) + a, period, is_leaf=is_axes)}
    return {"unroll": period * n}


# ------------------------------------------------------------- layer body
def _sublayer_input(p_norm: dict, x: torch.Tensor) -> torch.Tensor:
    """The normed residual that a sublayer reads. Under rules that shard the
    residual's sequence (``act_seq``) a sublayer works on the whole sequence
    ("seq"): the normed activation is gathered here once, as sequence
    parallelism does, where a DTensor projection would otherwise merge the
    batch and sequence shards into one dim that it cannot split again."""
    with span("layer.norm"):
        return lac(L.apply_norm(p_norm, x), "batch", "seq", None)


def _residual(x: torch.Tensor, out: torch.Tensor, mult: float) -> torch.Tensor:
    """x + a sublayer's output (times ``mult``, the config's
    ``residual_multiplier``), at the residual stream's placements: a
    sublayer whose heads or features are split leaves a partial sum, which
    is reduced here, where the next norm would otherwise pick a layout of
    its own for it (such as a sequence split, which a later product must
    flatten into a strided shard). The output's gradient returns whole
    along the sequence, as the sublayer's input was (``lac_grad``)."""
    if mult != 1.0:
        out = out * mult
    return lac(x + lac_grad(out, "batch", "seq", None), "batch", "act_seq", "residual")


def apply_layer(p: dict, cfg, kind: str, x: torch.Tensor, *, positions,
                cache: Optional[dict], mode: str, enc_out: Optional[torch.Tensor] = None,
                causal: bool = True, max_len: Optional[int] = None):
    """Pre-norm residual layer. Returns (x, new_cache, aux)."""
    aux: Dict[str, torch.Tensor] = {}
    rm = cfg.residual_multiplier
    h = _sublayer_input(p["ln1"], x)
    if kind == "attn":
        out, kvc, sf = L.apply_attention(
            p["attn"], cfg, h, positions=positions, causal=causal,
            cache=cache["kv"] if cache else None, mode=mode, max_len=max_len,
        )
        if sf:
            add_scan_flops(sf)
        x = _residual(x, out, rm)
        new_cache = {"kv": kvc} if kvc is not None else None
        if "cross" in p:  # decoder cross-attention sublayer
            cout, cc = L.apply_cross_attention(
                p["cross"], cfg, _sublayer_input(p["lnx"], x), enc_out,
                cache=cache["cross"] if cache else None, mode=mode,
            )
            x = _residual(x, cout, rm)
            if new_cache is not None and cc is not None:
                new_cache["cross"] = cc
    else:
        apply = {"mamba": S.apply_mamba, "mlstm": X.apply_mlstm,
                 "slstm": X.apply_slstm}.get(kind)
        if apply is None:
            raise ValueError(kind)
        out, new_cache = apply(p[kind], cfg, h, cache=cache, mode=mode)
        x = _residual(x, out, rm)
    if "moe" in p:
        h = _sublayer_input(p["ln2"], x)
        with span("moe"):
            y, aux = M.apply_moe(p["moe"], cfg, h)
        x = _residual(x, y, rm)
    elif "mlp" in p:
        h = _sublayer_input(p["ln2"], x)
        with span("mlp"):
            y = L.apply_mlp(p["mlp"], cfg, h)
        x = _residual(x, y, rm)
    return x, new_cache, aux


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux", "moe_z")}


def _add_aux(aux: dict, a: dict) -> None:
    for k, v in a.items():
        aux[k] = aux[k] + v


def _apply_period(pp, cfg, layout, x, *, positions, caches, mode, enc_out, causal,
                  max_len):
    """One period of layers. caches: tuple aligned with layout (or None).
    Returns (x, new_caches, aux)."""
    aux = _zero_aux(x.device)
    new_caches = []
    for i, (kind, _) in enumerate(layout):
        c = caches[i] if caches is not None else None
        x, nc, a = apply_layer(pp[i], cfg, kind, x, positions=positions, cache=c,
                               mode=mode, enc_out=enc_out, causal=causal,
                               max_len=max_len)
        _add_aux(aux, a)
        new_caches.append(nc)
    return x, tuple(new_caches), aux


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    if not _aliases(dst, src):  # in-place updates alias already
        dst.copy_(src)
    return dst


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``b`` lies in ``a``'s memory: the same storage at the same
    offset (a DTensor's: its shard's, which has no pointer of its own; a
    meta tensor's: its storage, whose pointer is 0)."""
    from torch.distributed.tensor import DTensor

    a, b = (t.to_local() if isinstance(t, DTensor) else t for t in (a, b))
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def apply_stack(params: dict, cfg, x: torch.Tensor, *, positions, caches=None,
                mode: str = "train", enc_out: Optional[torch.Tensor] = None,
                causal: bool = True, max_len: Optional[int] = None):
    """Run a stack. Returns (x, new_caches, aux); caches mirror the
    ``stack_cache_spec`` layout ({"scan": ...} or {"unroll": ...}), aux
    sums the MoE losses over every layer. ``enc_out`` is what a decoder's
    cross-attention reads outside decode; ``causal=False`` is the encoder's
    self-attention. In the stacked layout a decode step updates the stacked
    cache in place (a decoder's cross half passes through unwritten)."""
    layout = period_layout(cfg)
    want_cache = mode in ("prefill", "decode")
    use_remat = cfg.remat != "none" and mode == "train"
    aux = _zero_aux(x.device)

    def run_period(pp, x, pc):
        def fn(pp, x):
            return _apply_period(pp, cfg, layout, x, positions=positions, caches=pc,
                                 mode=mode, enc_out=enc_out, causal=causal,
                                 max_len=max_len)
        return L.remat(fn, pp, x) if use_remat else fn(pp, x)

    if "scan" in params:
        stacked = params["scan"]
        pc_stacked = caches["scan"] if caches is not None else None
        # one unbind per stacked leaf: its backward builds the stacked
        # gradient once, where a[i] in every period would build a zero
        # gradient of the whole leaf n times
        per_leaf = [a.unbind(0) for a in tree_leaves(stacked)]
        n = len(per_leaf[0])
        per_period = []
        for i in range(n):
            pp = tree_unflatten(stacked, [ts[i] for ts in per_leaf])
            pc = tree_map(lambda a, i=i: a[i], pc_stacked) if pc_stacked else None
            x, ncs, a = run_period(pp, x, pc)
            _add_aux(aux, a)
            if pc is not None:
                tree_map(_write_back, pc, ncs)
            elif want_cache:
                per_period.append(ncs)
        if not want_cache:
            return x, None, aux
        if pc_stacked is not None:
            return x, {"scan": pc_stacked}, aux
        return x, {"scan": tree_map(lambda *ls: torch.stack(ls), *per_period)}, aux

    per_layers = params["unroll"]
    n = len(per_layers) // len(layout)
    ncs_all: List[Any] = []
    for pi in range(n):
        pp = per_layers[pi * len(layout): (pi + 1) * len(layout)]
        pc = (caches["unroll"][pi * len(layout): (pi + 1) * len(layout)]
              if caches is not None else None)
        x, ncs, a = run_period(tuple(pp), x, tuple(pc) if pc else None)
        _add_aux(aux, a)
        ncs_all.extend(ncs)
    return x, ({"unroll": tuple(ncs_all)} if want_cache else None), aux
