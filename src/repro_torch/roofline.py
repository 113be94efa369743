"""Three-term roofline of a traced dry-run cell (port of
``src/repro/roofline.py``), with the H100's constants
(``launch/mesh.py``):

  compute    = FLOPs / (chips × 989e12)
  memory     = HBM bytes / (chips × 3.35e12)
  collective = wire bytes per device / 50e9

FLOPs and HBM bytes are the reference's **analytic** closed forms, plain
arithmetic on the config, copied with their order of operations
unchanged; the traced FLOPs (``FlopCounterMode`` over the per-device ops,
times the chips) are reported beside them as the cross-check that XLA's
``cost_analysis`` was.

Collective bytes come from the trace (``TraceRecorder``): every
``_c10d_functional`` collective that the DTensor program issues, priced
from its per-device shape and group size by the reference's ring model.
Python loops unroll, so no op needs a trip-count multiplier. The xLSTM
and SSD loops run inside ``local_map`` on each device's shards, so they
unroll there, as local ops that the recorder sees one by one.

A shard moved from one dim to another is priced as what torch emits for
it, which depends on the torch release: DTensor gathers the shard and
splits it again (an all-gather), where the reference prices the same move
as one all-to-all, local·(n-1)/n. A traced row's ``notes`` say so
(``RESHARD_NOTE``).
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.transformer import n_periods, period_layout


# =====================================================================
# Analytic FLOPs
# =====================================================================
def _attn_flops(cfg, B, S, Sk, causal=True, cross=False):
    kv, g, hd, d = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim, cfg.d_model
    proj = 2.0 * B * S * d * (kv * g * hd) * 2  # wq + wo
    proj += 2.0 * B * (Sk if cross else S) * d * (kv * hd) * 2  # wk + wv
    area = S * Sk * (0.5 if (causal and not cross and S == Sk) else 1.0)
    attn = 4.0 * B * area * kv * g * hd
    return proj + attn


def _mlp_flops(cfg, B, S, f=None):
    f = f if f is not None else cfg.d_ff
    n = 3 if cfg.mlp_kind == "swiglu" else 2
    return 2.0 * B * S * cfg.d_model * f * n


def _moe_flops(cfg, B, S):
    from repro_torch.models.moe import _capacity

    m = cfg.moe
    C = _capacity(S, cfg)
    n = 3 if cfg.mlp_kind == "swiglu" else 2
    router = 2.0 * B * S * cfg.d_model * m.num_experts
    expert = 2.0 * B * m.num_experts * C * cfg.d_model * m.expert_d_ff * n
    return router + expert


def _mamba_flops(cfg, B, S):
    from repro_torch.models.ssm import mamba_dims

    di, H, N, Pd = mamba_dims(cfg)
    d = cfg.d_model
    mc = cfg.mamba
    L = min(mc.chunk, S)
    nc = max(S // L, 1)
    proj = 2.0 * B * S * d * (2 * di + 2 * N + H)  # wz,wx,wB,wC,wdt
    conv = 2.0 * B * S * (di + 2 * N) * mc.d_conv
    G = 2.0 * B * nc * L * L * N  # C·B pair terms
    intra = 2.0 * B * nc * L * L * H * Pd + G
    states = 2.0 * B * S * N * H * Pd  # chunk states
    inter = 2.0 * B * S * N * H * Pd  # y_inter
    out = 2.0 * B * S * di * d
    return proj + conv + intra + states + inter + out


def _mlstm_flops(cfg, B, S):
    xc = cfg.xlstm
    d = cfg.d_model
    di = int(d * xc.mlstm_proj_factor)
    H = cfg.num_heads
    Pd = di // H
    from repro_torch.models.xlstm import MLSTM_CHUNK

    L = min(MLSTM_CHUNK, S)
    up = 2.0 * B * S * d * 2 * di
    qkv = 3 * 2.0 * B * S * di * di
    cell = 2.0 * B * H * S * L * (3 * Pd)  # QK^T, WV, state einsums
    out = 2.0 * B * S * di * d
    return up + qkv + cell + out


def _slstm_flops(cfg, B, S):
    xc = cfg.xlstm
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    df = int(d * xc.slstm_proj_factor)
    wx = 2.0 * B * S * d * 4 * d
    rec = 2.0 * B * S * 4 * H * dh * dh
    mlp = 2.0 * B * S * d * 2 * df + 2.0 * B * S * df * d
    return wx + rec + mlp


def layer_flops(cfg, kind: str, is_moe: bool, B, S, Sk=None, decoder=False):
    Sk = Sk if Sk is not None else S
    f = 0.0
    if kind == "attn":
        f += _attn_flops(cfg, B, S, Sk)
        if decoder and cfg.encoder_decoder:
            f += _attn_flops(cfg, B, S, cfg.frontend_seq, cross=True)
    elif kind == "mamba":
        f += _mamba_flops(cfg, B, S)
    elif kind == "mlstm":
        f += _mlstm_flops(cfg, B, S)
    elif kind == "slstm":
        f += _slstm_flops(cfg, B, S)
    if is_moe:
        f += _moe_flops(cfg, B, S)
    elif cfg.d_ff > 0:
        f += _mlp_flops(cfg, B, S)
    return f


def forward_flops(cfg, B, S, Sk=None, include_head=True) -> float:
    """One forward pass over (B, S) tokens (self-attention context Sk)."""
    total = 0.0
    layout = period_layout(cfg)
    n = n_periods(cfg)
    Sx = S + (cfg.frontend_seq if cfg.frontend == "vision" else 0)
    for kind, is_moe in layout:
        total += layer_flops(cfg, kind, is_moe, B, Sx, Sk, decoder=cfg.encoder_decoder) * n
    if cfg.encoder_decoder:
        ne = n_periods(cfg, cfg.num_encoder_layers)
        F = cfg.frontend_seq
        for kind, is_moe in layout:
            total += layer_flops(cfg, kind, is_moe, B, F, F) * ne
    if include_head:
        total += 2.0 * B * Sx * cfg.d_model * cfg.vocab_size
    return total


def decode_flops(cfg, B, cache_len: int) -> float:
    """One decode step: S=1, attention against cache_len keys."""
    total = 0.0
    layout = period_layout(cfg)
    n = n_periods(cfg)
    for kind, is_moe in layout:
        if kind == "attn":
            f = _attn_flops(cfg, B, 1, cache_len, causal=False)
            if cfg.encoder_decoder:
                f += _attn_flops(cfg, B, 1, cfg.frontend_seq, cross=True)
        elif kind == "mamba":
            from repro_torch.models.ssm import mamba_dims

            di, H, N, Pd = mamba_dims(cfg)
            f = 2.0 * B * cfg.d_model * (2 * di + 2 * N + H) + 4.0 * B * H * N * Pd + 2.0 * B * di * cfg.d_model
        elif kind == "mlstm":
            di = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)
            Pd = di // cfg.num_heads
            f = 2.0 * B * cfg.d_model * 2 * di + 3 * 2.0 * B * di * di \
                + 4.0 * B * cfg.num_heads * Pd * Pd + 2.0 * B * di * cfg.d_model
        elif kind == "slstm":
            dh = cfg.d_model // cfg.num_heads
            f = 2.0 * B * cfg.d_model * 4 * cfg.d_model \
                + 2.0 * B * 4 * cfg.num_heads * dh * dh \
                + _slstm_flops(cfg, B, 1) * 0  # mlp counted below
            df = int(cfg.d_model * cfg.xlstm.slstm_proj_factor)
            f += 2.0 * B * cfg.d_model * 2 * df + 2.0 * B * df * cfg.d_model
        else:
            f = 0.0
        if is_moe:
            f += _moe_flops(cfg, B, 1)
        elif cfg.d_ff > 0:
            f += _mlp_flops(cfg, B, 1)
        total += f * n
    total += 2.0 * B * cfg.d_model * cfg.vocab_size
    return total


def count_params(cfg) -> Tuple[float, float, float]:
    """(total, active, embedding) parameter counts."""
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_flatten_with_path

    model = build_model(cfg)
    spec = model.spec()
    total = 0.0
    expert = 0.0
    embed = float(cfg.vocab_size * cfg.d_model) * (1 if cfg.tie_embeddings else 2)
    for _, leaf in tree_flatten_with_path(spec):
        sz = float(math.prod(leaf.shape))
        total += sz
        # expert FFN weights: rank-3 (+1 with the stacked "layers" dim)
        if "experts" in leaf.axes and len(leaf.shape) >= 3:
            expert += sz
    if cfg.moe is not None:
        active = total - expert * (1.0 - cfg.moe.experts_per_token / cfg.moe.num_experts)
    else:
        active = total
    return total, active, embed


# =====================================================================
# Analytic HBM bytes (documented estimators — see EXPERIMENTS.md)
# =====================================================================
def train_bytes(cfg, plan, B, S) -> float:
    total_p, _, _ = count_params(cfg)
    pb = total_p * 4  # f32 params
    mb = plan.microbatches
    weights = 2 * mb * pb + 6 * pb  # fwd+bwd reads per microbatch + optimizer r/w
    grads = 2 * mb * pb  # accumulate r+w per microbatch
    n = n_periods(cfg) * (2 if cfg.encoder_decoder else 1)
    act = 4.0 * n * B * S * cfg.d_model * 2  # carry saves w+r + recompute
    logits = 3.0 * B * S * cfg.vocab_size * 2
    kvread = 0.0
    if any(k == "attn" for k, _ in period_layout(cfg)):
        n_attn = sum(1 for k, _ in period_layout(cfg) if k == "attn") * n_periods(cfg)
        nq = max(S // 4096, 1)
        kvread = 2.0 * B * nq * S * cfg.num_kv_heads * cfg.head_dim * 2 * n_attn * 3
    return weights + grads + act + logits + kvread


def prefill_bytes(cfg, B, S) -> float:
    total_p, _, _ = count_params(cfg)
    pb = total_p * 2  # bf16
    n_attn = sum(1 for k, _ in period_layout(cfg) if k == "attn") * n_periods(cfg)
    cache_w = 2.0 * B * S * cfg.num_kv_heads * cfg.head_dim * 2 * n_attn
    act = 2.0 * (n_periods(cfg) * (2 if cfg.encoder_decoder else 1)) * B * S * cfg.d_model * 2
    nq = max(S // 4096, 1)
    kvread = 2.0 * B * nq * S * cfg.num_kv_heads * cfg.head_dim * 2 * n_attn
    return pb + cache_w + act + kvread


def decode_bytes(cfg, B, cache_len) -> float:
    total_p, _, _ = count_params(cfg)
    pb = total_p * 2  # every weight read once
    n_attn = sum(1 for k, _ in period_layout(cfg) if k == "attn") * n_periods(cfg)
    cache_r = 2.0 * B * cache_len * cfg.num_kv_heads * cfg.head_dim * 2 * n_attn
    state = 0.0
    for kind, _ in period_layout(cfg):
        if kind == "mamba":
            from repro_torch.models.ssm import mamba_dims

            di, H, N, Pd = mamba_dims(cfg)
            state += 2.0 * B * H * N * Pd * 4 * n_periods(cfg)
        elif kind == "mlstm":
            di = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)
            Pd = di // cfg.num_heads
            state += 2.0 * B * cfg.num_heads * Pd * Pd * 4 * n_periods(cfg)
    return pb + cache_r + state


# =====================================================================
# Collectives of the trace
# =====================================================================
def wire_bytes(kind: str, local: float, n: int) -> float:
    """Per-device wire bytes of one collective (the reference's ring
    model). local = per-device bytes of the op's result, n = group size:
      all-reduce        2·local·(n-1)/n      (ring)
      all-gather        local·(n-1)/n        (result is the gathered shape)
      reduce-scatter    local·(n-1)          (input = n·result)
      all-to-all        local·(n-1)/n
      other (permute, broadcast) local
    """
    if kind == "all-reduce":
        return 2.0 * local * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return local * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return local * (n - 1)
    return local


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _NotMeta(Exception):
    pass


def _meta_key(x, seen: list):
    """A hashable signature of an op's arguments (each tensor's shape,
    stride, dtype and offset); ``seen`` gets each tensor. Raises
    ``_NotMeta`` for a tensor that is not on ``meta``."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NotMeta
        seen.append(x)
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (tuple, list)):
        return (type(x), *[_meta_key(e, seen) for e in x])
    if isinstance(x, dict):
        return tuple((k, _meta_key(v, seen)) for k, v in x.items())
    return x


class TraceRecorder(TorchDispatchMode):
    """One pass over the per-device ops of a DTensor program (DTensor ops
    pass through with ``NotImplemented``, so that DTensor desugars them
    into local ops and collectives first). It totals:
      * the wire bytes of each functional collective, by kind (``totals``,
        ``counts``);
      * FLOPs, by ``torch.utils.flop_counter``'s formulas (``flops``);
      * live device bytes: every storage an op creates counts from its
        creation until it is freed (``track`` the arguments first), and
        ``peak_bytes`` is the most at any time.
    Ops on FakeTensors are DTensor's own shape inference over global
    shapes, not device work, and count nowhere.

    On ``meta`` tensors an op's result depends on nothing but its
    arguments' shapes, strides and dtypes, and many meta kernels are
    Python; a loop repeats the same ops at the same shapes. So a pure op
    (no argument or result that aliases or is written, by its schema and
    by its first result) is run once per signature, and later calls
    allocate a result of the remembered layout.
    """

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._fake, self._dtensor = FakeTensor, DTensor
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.flops = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._meta_layouts: Dict[tuple, tuple] = {}
        self._pure: Dict[object, bool] = {}

    def track(self, tensors) -> None:
        for t in tensors:
            self._track(t)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        FakeTensor, DTensor = self._fake, self._dtensor
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        if any(t is FakeTensor for t in types):
            return func(*args, **kwargs)  # DTensor's shape inference on global fake shadows
        out = self._run(func, args, kwargs)
        if isinstance(out, FakeTensor):
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out)
        if getattr(func, "namespace", None) == "_c10d_functional":
            self._record(func._opname, args, out)
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out

    def _run(self, func, args, kwargs):
        pure = self._pure.get(func)
        if pure is None:
            sch = func._schema
            pure = self._pure[func] = (
                getattr(func, "namespace", None) == "aten"
                and not any(a.alias_info for a in sch.arguments) and bool(sch.returns)
                and all(r.alias_info is None and str(r.type) == "Tensor" for r in sch.returns))
        if not pure:
            return func(*args, **kwargs)
        seen = []
        try:
            key = (func, _meta_key((args, kwargs), seen))
            layouts = self._meta_layouts.get(key) if seen else None
        except (_NotMeta, TypeError):  # a tensor off meta, or an unhashable argument
            return func(*args, **kwargs)
        if layouts is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            ins = {t.untyped_storage()._cdata for t in seen}
            if any(o.untyped_storage()._cdata in ins for o in outs):
                self._pure[func] = False  # a view its schema does not declare
            elif seen:
                self._meta_layouts[key] = tuple((o.shape, o.stride(), o.dtype) for o in outs)
            return out
        outs = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                     for sh, st, dt in layouts)
        return outs if len(func._schema.returns) > 1 else outs[0]

    def _record(self, name: str, args, out) -> None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        if name.startswith("all_reduce"):
            kind, n = "all-reduce", _group_size(args[-1])
        elif name.startswith("all_gather"):
            kind, n = "all-gather", args[-2]
        elif name.startswith("reduce_scatter"):
            kind, n = "reduce-scatter", args[-2]
        elif name.startswith("all_to_all"):
            kind, n = "all-to-all", _group_size(args[-1])
        elif name.startswith("broadcast"):
            kind, n = "broadcast", _group_size(args[-1])
        else:  # wait_tensor and other bookkeeping
            return
        for o in outs:
            self.totals[kind] += wire_bytes(kind, float(_nbytes(o)), int(n))
        self.counts[kind] += 1

    def collectives(self) -> Dict[str, float]:
        out = dict(self.totals)
        out["total"] = sum(self.totals.values())
        return out


# =====================================================================
# Roofline report
# =====================================================================
RESHARD_NOTE = ("collectives as torch " + torch.__version__.split("+")[0] + " emits them: a "
                "shard moved between dims is priced as its all-gather, not as the "
                "reference's all-to-all")


@dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    flops: float
    hbm_bytes: float
    coll_bytes: float  # per-device wire bytes
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    flops_traced: float
    memory_per_device: float
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    notes: str = ""

    def row(self) -> str:
        return (
            f"{self.arch},{self.cell},{self.mesh},{self.chips},"
            f"{self.flops:.3e},{self.hbm_bytes:.3e},{self.coll_bytes:.3e},"
            f"{self.t_compute * 1e3:.3f},{self.t_memory * 1e3:.3f},"
            f"{self.t_collective * 1e3:.3f},{self.bottleneck},"
            f"{self.useful_ratio:.3f},{self.memory_per_device / 2**30:.2f}"
        )


HEADER = (
    "arch,cell,mesh,chips,flops,hbm_bytes,coll_bytes_per_dev,"
    "t_compute_ms,t_memory_ms,t_collective_ms,bottleneck,"
    "useful_flops_ratio,mem_GiB_per_dev"
)


def analytic(plan):
    """(flops, hbm_bytes, model_flops) of a plan's cell, from the config."""
    cfg, cell = plan.cfg, plan.cell
    B, S = cell.global_batch, cell.seq_len
    total_p, active_p, embed_p = count_params(cfg)
    if cell.kind == "train":
        fwd = forward_flops(cfg, B, S)
        flops = 3.0 * fwd
        hbm = train_bytes(cfg, plan, B, S)
        model_flops = 6.0 * (active_p - embed_p / 2) * B * S
    elif cell.kind == "prefill":
        flops = forward_flops(cfg, B, S)
        hbm = prefill_bytes(cfg, B, S)
        model_flops = 2.0 * (active_p - embed_p / 2) * B * S
    else:
        flops = decode_flops(cfg, B, S)
        hbm = decode_bytes(cfg, B, S)
        model_flops = 2.0 * (active_p - embed_p / 2) * B
    return flops, hbm, model_flops


def analyze(plan, trace, mesh_name: str) -> Roofline:
    """The roofline of a plan from its ``CellPlan.trace()`` record (with
    ``trace=None``: the analytic terms alone, no collective term)."""
    from repro_torch.launch.mesh import mesh_chips

    chips = mesh_chips(plan.rules.mesh)
    flops, hbm, model_flops = analytic(plan)
    colls = trace.collectives if trace is not None else {}
    t_c = flops / (chips * PEAK_FLOPS_BF16)
    t_m = hbm / (chips * HBM_BW)
    t_x = colls.get("total", 0.0) / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        arch=plan.arch, cell=plan.cell.name, mesh=mesh_name, chips=chips,
        flops=flops, hbm_bytes=hbm, coll_bytes=colls.get("total", 0.0),
        t_compute=t_c, t_memory=t_m, t_collective=t_x, bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops if flops else 0.0),
        flops_traced=(trace.flops_per_device * chips if trace is not None else 0.0),
        memory_per_device=float(trace.peak_bytes if trace is not None
                                else plan.arg_bytes()),
        coll_breakdown={k: v for k, v in colls.items() if k != "total"},
        notes=plan.notes + (f"; {RESHARD_NOTE}" if trace is not None else ""),
    )
