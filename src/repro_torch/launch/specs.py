"""Per-cell plans (port of ``src/repro/launch/specs.py``): abstract inputs
(``meta`` tensors — never allocated), sharding rules, input and output
PartitionSpecs and the step function for every (architecture × shape cell
× mesh) combination.

Cell semantics (assignment):
  * train_4k     — train_step (fwd+bwd+optimizer), global batch 256 × 4096
  * prefill_32k  — serve prefill: build the KV/state cache for 32 × 32768
  * decode_32k   — serve_step: one token against a 32768-entry cache, B=128
  * long_500k    — decode at 524288 context, B=1 (sub-quadratic archs only)

Sharding strategies, the reference's:
  * train: batch→(pod,data); tensor axes→model; ZeRO-1 opt state; per-arch
    microbatching; the ≥300B archs additionally FSDP params over data
    ("embed"→data) and sequence-shard the residual stream ("act_seq"→model).
  * decode: weights 2-axis sharded ("embed"→data on top of model-axis rules);
    KV cache sharded batch→dp + kv_seq→model (B=1 long-context: kv_seq over
    (data, model) — 256-way flash-decode layout).
  * prefill: decode weight rules + bf16 params; activations seq-sharded for
    attention-only archs.

A plan made on an ``AbstractMesh`` gives specs and per-device argument
bytes (``CellPlan.arg_bytes``). On a DeviceMesh, ``CellPlan.trace`` runs
the step on the plan's arguments as DTensors whose shards are ``meta``
tensors (on the fake production mesh: nothing is allocated or sent) and records
its collectives, its peak of live device bytes and its FLOPs; the same
``fn`` runs for real on a real mesh (``CellPlan.place``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.config import SHAPE_CELLS, ModelConfig, ShapeCell, get_config
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import _is_shape_dtype
from repro_torch.sharding import (PartitionSpec as P, ShardingRules, is_spec, make_rules,
                                  mesh_shape, use_rules)
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map

# per-arch gradient-accumulation microbatches for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "glm4-9b": 4,
    "granite-3-8b": 4,
    "qwen3-1.7b": 4,
    "mistral-nemo-12b": 8,
    "xlstm-125m": 1,
    "jamba-1.5-large-398b": 8,
    "seamless-m4t-large-v2": 2,
    "grok-1-314b": 8,
    "granite-moe-3b-a800m": 2,
    "phi-3-vision-4.2b": 4,
}

# archs whose params+state need FSDP (params sharded over data too) in train
FSDP_ARCHS = {"jamba-1.5-large-398b", "grok-1-314b"}
# archs that sequence-shard the residual stream in train (activation memory)
SEQ_SHARD_TRAIN = {"jamba-1.5-large-398b", "grok-1-314b", "mistral-nemo-12b"}
# archs with recurrent/conv blocks: no seq-sharded prefill (locality)
NO_SEQ_PREFILL = {"xlstm-125m", "jamba-1.5-large-398b"}

ALL_ARCHS = list(TRAIN_MICROBATCHES)

# Hillclimb variants of the reference, opt-in via plan_cell(perf=True) or
# `dryrun --perf`. Baseline = the sharding above.
#   * small-model train (<1B): fold the model axis into data parallelism
#     (batch over BOTH axes, weights replicated).
#   * MoE decode: weight-stationary serving — replicate the tiny per-token
#     activations instead of the weights.
#   * giant-MoE train: bf16 params under Adafactor.
PERF_SMALL_TRAIN = {"xlstm-125m", "qwen3-1.7b"}
PERF_WEIGHT_STATIONARY_DECODE = {"jamba-1.5-large-398b", "grok-1-314b"}
PERF_BF16_TRAIN = {"jamba-1.5-large-398b", "grok-1-314b"}


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


@dataclass
class Trace:
    """What ``CellPlan.trace`` recorded, per device."""

    collectives: Dict[str, float]  # wire bytes by kind, and "total"
    collective_counts: Dict[str, int]
    arg_bytes: int
    out_bytes: int  # outputs that are not (in-place updated) arguments
    peak_bytes: int  # peak of live device bytes, arguments included
    flops_per_device: float
    seconds: float
    microbatches_traced: int = 1

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.arg_bytes


@dataclass
class CellPlan:
    arch: str
    cell: ShapeCell
    cfg: ModelConfig
    model: Model
    rules: ShardingRules
    fn: Callable
    abstract_args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any  # None where the output is left where the step puts it
    microbatches: int = 1
    notes: str = ""
    microbatch_fn: Optional[Callable] = None  # train: the step over one microbatch

    def arg_bytes(self) -> int:
        """Per-device bytes of the arguments under their specs."""
        return sum(tree_leaves(self.map_args(
            lambda sp, a: _nbytes(self.rules.local_shape(sp, a.shape), a.dtype))))

    def map_args(self, fn, args=None):
        """``fn(spec, arg)`` over the in specs and ``args`` (default: the
        abstract args), which must have the specs' structure."""
        return tree_map(fn, self.in_specs,
                        self.abstract_args if args is None else args, is_leaf=is_spec)

    def place(self, args):
        """``args``, this rank's shards of the plan's arguments (on a mesh
        of one device, the whole tensors), as DTensors on the rules'
        DeviceMesh at the in specs, keeping their storage."""
        from torch.distributed.tensor import DTensor

        mesh = self.rules.mesh
        return self.map_args(lambda sp, t: DTensor.from_local(
            t, mesh, self.rules.placements(sp), run_check=False), args)

    def constrain(self, out):
        """``out`` with each DTensor leaf under an out spec redistributed
        there (the port's ``out_shardings``)."""
        return _constrain(out, self.out_specs, self.rules)

    def trace(self, one_microbatch: bool = False) -> Trace:
        """Run ``fn`` on the plan's DeviceMesh with every argument a DTensor
        at its placements, its local shards on the ``meta`` device (nothing
        is allocated; on the fake production mesh nothing is sent), under
        the plan's rules; record collectives and their wire bytes, the peak
        of live device bytes and the FLOPs, per device.

        ``one_microbatch``: a train step of several microbatches is traced
        over one (``microbatch_fn`` on the batch cut to one microbatch), and
        its collectives and FLOPs are scaled by the microbatch count; the
        once-a-step grad reduction and update are then counted that many
        times too."""
        from torch.distributed.tensor import DTensor

        from repro_torch.roofline import TraceRecorder

        mesh = self.rules.mesh
        t0 = time.perf_counter()

        def abstract(sp, a):
            local = torch.empty(self.rules.local_shape(sp, a.shape), dtype=a.dtype,
                                device="meta")
            return DTensor.from_local(local, mesh, self.rules.placements(sp),
                                      run_check=False, shape=a.shape,
                                      stride=_contiguous_strides(a.shape))

        fn, abstract_args, scale = self.fn, self.abstract_args, 1
        if one_microbatch and self.microbatch_fn is not None and self.microbatches > 1:
            scale = self.microbatches
            state, batch = abstract_args
            fn, abstract_args = self.microbatch_fn, (state, {
                k: _meta((v.shape[0] // scale,) + tuple(v.shape[1:]), v.dtype)
                for k, v in batch.items()})
        args = self.map_args(abstract, abstract_args)
        arg_ids = {id(a) for a in tree_leaves(args)}
        rec = TraceRecorder()
        rec.track(a.to_local() for a in tree_leaves(args))
        with use_rules(self.rules), rec:
            out = self.constrain(fn(*args))
        outs = [o for o in tree_leaves(out)
                if isinstance(o, torch.Tensor) and id(o) not in arg_ids]
        out_bytes = sum(_local(o).numel() * o.element_size() for o in outs)
        return Trace(collectives={k: v * scale for k, v in rec.collectives().items()},
                     collective_counts={k: v * scale for k, v in rec.counts.items()},
                     arg_bytes=self.arg_bytes(), out_bytes=out_bytes,
                     peak_bytes=rec.peak_bytes, flops_per_device=rec.flops * scale,
                     seconds=time.perf_counter() - t0, microbatches_traced=(
                         1 if scale > 1 else self.microbatches))


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _constrain(out, specs, rules: ShardingRules):
    from torch.distributed.tensor import DTensor

    if specs is None:
        return out
    if is_spec(specs):
        if not isinstance(out, DTensor):
            return out
        want = rules.placements(specs)
        return out if tuple(out.placements) == want else out.redistribute(out.device_mesh, want)
    if isinstance(specs, dict):
        return {k: _constrain(out[k], specs[k], rules) for k in out}
    parts = [_constrain(o, s, rules) for o, s in zip(out, specs, strict=True)]
    return tuple(parts) if isinstance(out, tuple) else parts


class CellSkip(Exception):
    pass


def skip_reason(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "full-attention arch at 524288 ctx — no sub-quadratic mechanism; "
            "skipped per assignment (DESIGN.md §7)"
        )
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_abstract(cfg: ModelConfig, B: int, S: int, *, labels: bool):
    """Model inputs for a (B, S) token batch, honoring stub frontends."""
    d = {"tokens": _meta((B, S), torch.int32)}
    axes = {"tokens": ("batch", None)}
    if cfg.frontend == "vision":
        # patches replace the leading frontend_seq positions of the budget
        st = S - cfg.frontend_seq
        if st <= 0:
            raise ValueError("cell seq budget smaller than vision frontend")
        d["tokens"] = _meta((B, st), torch.int32)
        d["frontend"] = _meta((B, cfg.frontend_seq, cfg.d_model), cfg.compute_dtype)
        axes["frontend"] = ("batch", None, None)
        if labels:
            d["labels"] = _meta((B, st), torch.int32)
            axes["labels"] = ("batch", None)
    elif cfg.frontend == "audio":
        d["frontend"] = _meta((B, cfg.frontend_seq, cfg.d_model), cfg.compute_dtype)
        axes["frontend"] = ("batch", None, None)
        if labels:
            d["labels"] = _meta((B, S), torch.int32)
            axes["labels"] = ("batch", None)
    elif labels:
        d["labels"] = _meta((B, S), torch.int32)
        axes["labels"] = ("batch", None)
    return d, axes


def _decode_rules(mesh, cfg, *, kv_all_axes: bool) -> ShardingRules:
    r = make_rules(mesh, cfg)
    rules = dict(r.rules)
    rules["embed"] = "data"  # 2-axis weight sharding for serving
    rules["kv_seq"] = ("data", "model") if kv_all_axes else "model"
    return ShardingRules(mesh, rules)


def _train_rules(mesh, cfg, perf: bool = False) -> ShardingRules:
    r = make_rules(mesh, cfg)
    rules = dict(r.rules)
    if cfg.name in FSDP_ARCHS:
        rules["embed"] = "data"
        rules["embed_shard"] = "data"
    if cfg.name in SEQ_SHARD_TRAIN:
        rules["act_seq"] = "model"
    if perf and cfg.name in PERF_SMALL_TRAIN:
        # fold the model axis into data parallelism: batch over both axes,
        # every weight replicated → zero per-layer TP collectives
        dp = (("pod", "data", "model") if "pod" in mesh_shape(mesh)
              else ("data", "model"))
        for k in rules:
            rules[k] = None
        rules["batch"] = dp
    return ShardingRules(mesh, rules)


def _prefill_rules(mesh, cfg) -> ShardingRules:
    r = _decode_rules(mesh, cfg, kv_all_axes=False)
    rules = dict(r.rules)
    if cfg.name not in NO_SEQ_PREFILL:
        rules["act_seq"] = "model"
    return ShardingRules(mesh, rules)


def plan_cell(arch: str, cell_name: str, mesh, perf: bool = False,
              batch: Optional[int] = None, seq: Optional[int] = None,
              **overrides) -> CellPlan:
    """The plan of one cell on ``mesh``. ``batch`` and ``seq`` cut the
    cell's global batch and length (a run on fewer devices than the cell's
    mesh, or at a test's size); ``overrides`` change the config."""
    cfg = get_config(arch, **overrides) if overrides else get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    if batch is not None:
        cell = dataclasses.replace(cell, global_batch=batch)
    if seq is not None:
        cell = dataclasses.replace(cell, seq_len=seq)
    reason = skip_reason(cfg, cell)
    if reason:
        raise CellSkip(reason)
    if cell.kind == "train":
        return _plan_train(arch, cfg, cell, mesh, perf)
    if cell.kind == "prefill":
        return _plan_prefill(arch, cfg, cell, mesh)
    return _plan_decode(arch, cfg, cell, mesh, perf)


# --------------------------------------------------------------- training
def _plan_train(arch, cfg, cell, mesh, perf: bool = False) -> CellPlan:
    if perf and arch in PERF_BF16_TRAIN:
        cfg = cfg.with_(param_dtype=torch.bfloat16)
    model = build_model(cfg)
    rules = _train_rules(mesh, cfg, perf)
    opt = optim.for_config(cfg)
    mb = TRAIN_MICROBATCHES.get(arch, 1)

    abs_params = model.abstract_params()
    param_specs = rules.tree_specs(model.param_axes(), abs_params)
    abs_opt = opt.init(abs_params)
    dp_axes = ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
    opt_specs = optim.zero1_state_specs(opt, param_specs, abs_params, mesh, dp_axes)
    state_abs = {"params": abs_params, "opt": abs_opt, "step": _meta((), torch.int32)}
    state_specs = {"params": param_specs, "opt": opt_specs, "step": P()}

    B, S = cell.global_batch, cell.seq_len
    batch_abs, batch_axes = _batch_abstract(cfg, B, S, labels=True)
    batch_specs = {k: rules.spec(a, batch_abs[k].shape) for k, a in batch_axes.items()}

    grad_dtype = torch.bfloat16 if (perf and cfg.name in PERF_SMALL_TRAIN) else None
    fn = make_train_step(model, opt, microbatches=mb, grad_dtype=grad_dtype)
    return CellPlan(
        arch=arch, cell=cell, cfg=cfg, model=model, rules=rules, fn=fn,
        abstract_args=(state_abs, batch_abs),
        in_specs=(state_specs, batch_specs),
        out_specs=(state_specs, None),
        microbatches=mb,
        microbatch_fn=make_train_step(model, opt, grad_dtype=grad_dtype),
        notes=f"opt={opt.name} mb={mb} fsdp={arch in FSDP_ARCHS} "
        f"seqshard={arch in SEQ_SHARD_TRAIN}",
    )


# ---------------------------------------------------------------- serving
def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.with_(param_dtype=torch.bfloat16)  # bf16 weights for inference


def _cache_specs(model: Model, rules: ShardingRules, B: int, max_len: int):
    abs_cache = tree_map(lambda s: _meta(*s), model.cache_spec(B, max_len),
                         is_leaf=_is_shape_dtype)
    return abs_cache, rules.tree_specs(model.cache_axes(), abs_cache)


def _plan_prefill(arch, cfg, cell, mesh) -> CellPlan:
    cfg = _serve_cfg(cfg)
    model = build_model(cfg)
    rules = _prefill_rules(mesh, cfg)
    B, S = cell.global_batch, cell.seq_len

    abs_params = model.abstract_params()
    param_specs = rules.tree_specs(model.param_axes(), abs_params)
    batch_abs, batch_axes = _batch_abstract(cfg, B, S, labels=False)
    batch_specs = {k: rules.spec(a, batch_abs[k].shape) for k, a in batch_axes.items()}

    # prefill cache covers the cell's full budget (vision: patches + text)
    _, cache_specs = _cache_specs(model, rules, B, S)
    fn = make_prefill_step(model, max_len=S)
    return CellPlan(
        arch=arch, cell=cell, cfg=cfg, model=model, rules=rules, fn=fn,
        abstract_args=(abs_params, batch_abs),
        in_specs=(param_specs, batch_specs),
        out_specs=(None, cache_specs),
        notes=f"bf16 params, seq_shard={arch not in NO_SEQ_PREFILL}",
    )


def _plan_decode(arch, cfg, cell, mesh, perf: bool = False) -> CellPlan:
    cfg = _serve_cfg(cfg)
    model = build_model(cfg)
    B, S = cell.global_batch, cell.seq_len
    rules = _decode_rules(mesh, cfg, kv_all_axes=(B == 1))
    if perf and arch in PERF_WEIGHT_STATIONARY_DECODE:
        # weight-stationary decode: replicate the (tiny) per-token batch,
        # keep weights resident 2-axis sharded — kills per-layer all-gathers
        rules = ShardingRules(mesh, dict(rules.rules, batch=None))

    abs_params = model.abstract_params()
    param_specs = rules.tree_specs(model.param_axes(), abs_params)
    abs_cache, cache_specs = _cache_specs(model, rules, B, S)
    tok_abs = _meta((B, 1), torch.int32)
    tok_spec = rules.spec(("batch", None), (B, 1))

    raw_decode = make_decode_step(model)

    def decode_step(params, cache, tokens):
        nxt, logits, new_cache = raw_decode(params, cache, tokens)
        return nxt, new_cache

    return CellPlan(
        arch=arch, cell=cell, cfg=cfg, model=model, rules=rules, fn=decode_step,
        abstract_args=(abs_params, abs_cache, tok_abs),
        in_specs=(param_specs, cache_specs, tok_spec),
        out_specs=(None, cache_specs),
        notes=f"bf16 params, kv_seq={'(data,model)' if B == 1 else 'model'}",
    )


def input_specs(arch: str, cell_name: str, mesh=None):
    """Assignment API: ``meta`` stand-ins for every model input of the
    (arch × cell). Returns the plan's abstract argument tuple."""
    if mesh is None:
        from repro_torch.launch.mesh import abstract_production_mesh

        mesh = abstract_production_mesh()
    return plan_cell(arch, cell_name, mesh).abstract_args
