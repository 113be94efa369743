"""Mixture-of-Experts (port of ``src/repro/models/moe.py``) with the same
sort-free gather/scatter dispatch: dispatch work stays O(tokens·k), not
O(tokens·E·C).

Dispatch is per sequence: each (token, k) pair takes the next slot of its
expert's queue, in the order of the (token, k) pairs flattened to S·K;
slots past the capacity C = ceil8(S·k·capacity_factor / E) are dropped
(their gate weight becomes 0). The gates are the top-k router
probabilities renormalised to sum to 1. The top k breaks ties to the lower
expert index, as ``jax.lax.top_k`` does, so that ties cannot change the
dispatch. The expert products are plain matmuls: the JAX module has no
Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding import lac


def moe_spec(cfg) -> dict:
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.expert_d_ff
    spec = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.1),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.mlp_kind == "swiglu":
        spec["wg"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"))
    return spec


def _capacity(S: int, cfg) -> int:
    m = cfg.moe
    c = int(S * m.experts_per_token * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s promise, which
    ``torch.topk`` does not make)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: dict, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B,S,D) → (y (B,S,D), {"moe_aux", "moe_z"})."""
    B, S, D = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    C = _capacity(S, cfg)
    dev = x.device

    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate, eidx = top_k(probs, K)  # (B,S,K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (Switch load-balance + router z-loss)
    me = probs.mean(1)  # (B,E) mean prob per expert
    ce = F.one_hot(eidx[..., 0], E).float().mean(1)  # top-1 assignment fraction
    aux = (me * ce).sum(-1).mean() * E * m.router_aux_weight
    zloss = (torch.logsumexp(logits, -1) ** 2).mean() * m.router_z_weight

    # ---- slot assignment: position of each (token,k) within its expert queue
    T = S * K
    ef = eidx.reshape(B, T)
    pos = torch.cumsum(F.one_hot(ef, E), dim=1) - 1  # (B,T,E), integer
    pos = pos.gather(-1, ef[..., None])[..., 0]  # (B,T)
    keep = pos < C
    slot = torch.where(keep, ef * C + pos, E * C)  # overflow -> the zero row

    # ---- scatter token ids to the E·C slots. Each dropped pair writes a
    # scratch slot of its own past E·C (JAX writes them all to one scratch
    # slot), so no two writes meet; the scratch slots are cut off.
    t = torch.arange(T, device=dev)
    dest = torch.where(keep, slot, E * C + t)
    slot2tok = torch.full((B, E * C + T), S, dtype=torch.long, device=dev)
    slot2tok = slot2tok.scatter(1, dest, (t // K).expand(B, T))[:, : E * C]
    xp = torch.cat([x, x.new_zeros((B, 1, D))], 1).reshape(B * (S + 1), D)  # pad row S
    rows = (slot2tok + (S + 1) * torch.arange(B, device=dev)[:, None]).reshape(-1)
    xe = xp.index_select(0, rows).reshape(B, E, C, D)
    xe = lac(xe, "batch", "experts", None, None)

    # ---- expert FFN
    h = torch.einsum("becd,edf->becf", xe, p["wi"].to(x.dtype))
    if "wg" in p:
        g = torch.einsum("becd,edf->becf", xe, p["wg"].to(x.dtype))
        h = F.silu(g) * h
    else:
        h = gelu(h)
    # the einsum above leaves h a DTensor whose global strides are permuted
    # while its shards are contiguous; the next einsum's views need them to agree
    h = h.contiguous()
    ye = torch.einsum("becf,efd->becd", h, p["wo"].to(x.dtype))
    ye = lac(ye, "batch", "experts", None, None)

    # ---- combine: gather each (token,k) result from its slot, weight, sum
    yef = torch.cat([ye.reshape(B, E * C, D), ye.new_zeros((B, 1, D))], 1)
    rows = (slot + (E * C + 1) * torch.arange(B, device=dev)[:, None]).reshape(-1)
    ytk = yef.reshape(B * (E * C + 1), D).index_select(0, rows).reshape(B, T, D)
    w = (gate.reshape(B, T) * keep).to(x.dtype)
    y = (ytk * w[..., None]).reshape(B, S, K, D).sum(2)
    y = lac(y, "batch", "seq", None)
    return y, {"moe_aux": aux, "moe_z": zloss}


def moe_active_flops(B: int, S: int, cfg) -> float:
    """Analytic active expert FLOPs (slots × per-slot FFN cost)."""
    m = cfg.moe
    C = _capacity(S, cfg)
    n_mats = 3 if cfg.mlp_kind == "swiglu" else 2
    return 2.0 * B * m.num_experts * C * cfg.d_model * m.expert_d_ff * n_mats
