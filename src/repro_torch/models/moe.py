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

The port's own options (``MoEConfig``), which the JAX package lacks:
``dropless`` computes every (token, k) pair: the pairs of the whole batch
sorted by expert (stable), their rows gathered, one grouped product
(``torch._grouped_mm``) over the experts' contiguous rows, then
un-permuted by a gather and summed over k, with no scatter-add, so the
sums are deterministic. ``shared_d_ff`` adds a shared SwiGLU expert that
every token passes through. ``dispatch_counters`` reads, from the
router's choices, the pairs a config's dispatch drops and the busiest
expert's load. Spans: ``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.shared`` and ``moe.combine``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, gelu, mlp_spec
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding import lac, lac_grad, per_shard
from repro_torch.spans import span


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
    if m.shared_d_ff:
        spec["shared"] = mlp_spec(cfg, m.shared_d_ff)
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


_BSD = ("batch", None, None)


def _rows_of(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B,N,D), idx (B,M) → (B,M,D): row idx[b, j] of a[b], and a zero
    row where idx[b, j] == N, as one flat gather."""
    B, N, D = a.shape
    ap = torch.cat([a, a.new_zeros((B, 1, D))], 1).reshape(B * (N + 1), D)
    rows = (idx + (N + 1) * torch.arange(B, device=a.device)[:, None]).reshape(-1)
    return ap.index_select(0, rows).reshape(B, idx.shape[1], D)


_BECD = ("batch", "experts", None, None)


def _expert_in(xe, wi, wg=None):
    """xe (B,E,C,D), wi and wg (E,D,F) → the activated hidden (B,E,C,F),
    contiguous: the output product views it with its rows flattened, which
    over a DTensor einsum's permuted result needs the layout made whole."""
    h = torch.einsum("becd,edf->becf", xe, wi)
    h = F.silu(torch.einsum("becd,edf->becf", xe, wg)) * h if wg is not None else gelu(h)
    return h.contiguous()


def _route(p: dict, cfg, x: torch.Tensor):
    """Router product, softmax, top k, renormalised gates and the aux
    losses: (gate (B,S,K) f32, eidx (B,S,K), {"moe_aux", "moe_z"})."""
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    # the router product's gradient whole along the sequence, as its input
    # is: DTensor would split it there, which the product's backward must
    # flatten with the batch into a strided shard
    logits = lac_grad(x @ p["router"].to(x.dtype), "batch", "seq", None).float()
    probs = torch.softmax(logits, -1)
    gate, eidx = top_k(probs, K)  # (B,S,K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (Switch load-balance + router z-loss)
    me = probs.mean(1)  # (B,E) mean prob per expert
    ce = F.one_hot(eidx[..., 0], E).float().mean(1)  # top-1 assignment fraction
    aux = (me * ce).sum(-1).mean() * E * m.router_aux_weight
    zloss = (torch.logsumexp(logits, -1) ** 2).mean() * m.router_z_weight
    return gate, eidx, {"moe_aux": aux, "moe_z": zloss}


def dispatch_counters(cfg, eidx: torch.Tensor) -> dict:
    """From the router's choices eidx (B,S,K): ``moe_dropped``, the pairs
    that the config's dispatch drops (past an expert's capacity in a
    sequence; none where it is ``dropless``), and ``moe_load_max``, the
    busiest expert's pairs over the mean, both f32."""
    m = cfg.moe
    B, S, K = eidx.shape
    counts = F.one_hot(eidx.reshape(B, S * K), m.num_experts).sum(1)  # (B,E)
    over = 0 if m.dropless else (counts - _capacity(S, cfg)).clamp_min(0).sum()
    total = counts.sum(0)
    return {"moe_dropped": torch.as_tensor(over, dtype=torch.float32),
            "moe_load_max": total.max().float() * (m.num_experts / (B * S * K))}


def apply_moe(p: dict, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B,S,D) → (y (B,S,D), {"moe_aux", "moe_z"})."""
    with span("moe.route"):
        gate, eidx, aux = _route(p, cfg, x)
    shared = None
    if "shared" in p:
        with span("moe.shared"):
            shared = apply_mlp(p["shared"], cfg, x)
    dispatch = _dropless if cfg.moe.dropless else _capacity_dispatch
    return dispatch(p, cfg, x, gate, eidx, shared), aux


def _capacity_dispatch(p: dict, cfg, x, gate, eidx, shared):
    """The JAX package's dispatch: y (B,S,D), plus ``shared`` where
    given."""
    B, S, D = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    C = _capacity(S, cfg)
    dev = x.device

    with span("moe.dispatch"):
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
        # the gathers are each batch row's own: on DTensors they run on each
        # device's rows (``per_shard``), where DTensor would flatten the batch
        # with a split dim, or index a split row dim with global row numbers
        xe = per_shard(lambda a, i: _rows_of(a, i).reshape(i.shape[0], E, C, D),
                       (x, slot2tok), (_BSD, ("batch", None)), (("batch", None, None, None),))
        # its gradient comes back with the experts whole, as the gather made
        # them (``lac_grad``)
        xe = lac(lac_grad(xe, "batch", None, None, None), *_BECD)

    with span("moe.experts"):
        # ---- expert FFN. While autograd records, the input products and the
        # activation, which sum over no split dim, run on each device's shards
        # (``per_shard``), the weights whole along d as FSDP gathers them: the
        # backward of DTensor's einsum views permuted shards as if they were
        # contiguous on torch 2.11 (grok-1 train_4k on 2x16x16). A serving step
        # keeps DTensor's plan, which sums each shard's part of a split d and
        # reduces the hidden: at decode's few tokens, less than the weights.
        ws = [p[k].to(x.dtype) for k in ("wi", "wg") if k in p]
        if xe.requires_grad:
            h = per_shard(_expert_in, (xe, *ws),
                          (_BECD,) + (("experts", None, "expert_mlp"),) * len(ws),
                          (("batch", "experts", None, "expert_mlp"),))
        else:
            h = _expert_in(xe, *ws)
        ye = torch.einsum("becf,efd->becd", h, p["wo"].to(x.dtype))
        ye = lac(ye, "batch", "experts", None, None)

    with span("moe.combine"):
        # ---- combine: gather each (token,k) result from its slot, weight, sum
        ytk = per_shard(lambda a, i: _rows_of(a.reshape(a.shape[0], E * C, D), i),
                        (ye, slot), (("batch", None, None, None), ("batch", None)), (_BSD,))
        w = (gate.reshape(B, T) * keep).to(x.dtype)
        y = (ytk * w[..., None]).reshape(B, S, K, D).sum(2)
        y = lac(y, "batch", "seq", None)
        if shared is not None:
            y = y + shared
    return y


def _dropless(p: dict, cfg, x, gate, eidx, shared):
    """Every (token, k) pair of the batch through its expert: y (B,S,D),
    plus ``shared`` where given."""
    B, S, D = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    with span("moe.dispatch"):
        flat = eidx.reshape(-1)  # (B·S·K,) pairs in (token, k) order
        by_expert, order = torch.sort(flat, stable=True)
        # each expert's last row + 1, found in the sorted ids: no count that
        # the host must wait for (``bincount`` on a CUDA device syncs)
        offs = torch.searchsorted(by_expert, torch.arange(1, E + 1, device=flat.device),
                                  out_int32=True)
        xs = x.reshape(B * S, D).index_select(0, order // K)  # (T, D) by expert
    with span("moe.experts"):
        # each expert's rows times its own (E, in, out) weight, one grouped
        # product over the sorted rows
        def grouped(a, w):
            return torch._grouped_mm(a, w.to(x.dtype), offs=offs)

        h = grouped(xs, p["wi"])
        h = F.silu(grouped(xs, p["wg"])) * h if "wg" in p else gelu(h)
        ys = grouped(h, p["wo"])  # (T, D)
    with span("moe.combine"):
        inv = torch.argsort(order)  # each pair's row among the sorted
        ytk = ys.index_select(0, inv).reshape(B, S, K, D)
        y = (ytk * gate.to(x.dtype)[..., None]).sum(2)
        if shared is not None:
            y = y + shared
    return y


def moe_active_flops(B: int, S: int, cfg) -> float:
    """Analytic active expert FLOPs (slots × per-slot FFN cost)."""
    m = cfg.moe
    C = _capacity(S, cfg)
    n_mats = 3 if cfg.mlp_kind == "swiglu" else 2
    return 2.0 * B * m.num_experts * C * cfg.d_model * m.expert_d_ff * n_mats
