"""Optimizers (port of ``src/repro/train/optim.py``): AdamW, Adafactor,
SGD with momentum, the cosine schedule.

Each optimizer is a pair of functions packaged in :class:`Optimizer`:
``init(params) → state`` and ``update(grads, state, params, step) →
(params, state)``. State trees mirror params leaf for leaf (Adafactor
hangs a small dict {vr, vc} or {v} under each param leaf). The arithmetic
is the JAX package's, op for op, in f32. Unlike JAX, ``update`` writes the
new params and state into the tensors it is given and returns them: at
qwen3-1.7b's 2.03 B f32 parameters a functional update would hold a
second 24 GB copy of params and moments.

ZeRO-1 (``zero1_*``) gives the optimizer state's PartitionSpecs: each
param's spec with the data-parallel axes added on its first unsharded dim
that they divide. Under those specs the moments are DTensors sharded
further than their params, and the in-place update computes each shard
where it lies, then writes the params back at their own placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.sharding import PartitionSpec, is_spec, mesh_shape
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    factored: bool = False


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def _clip_scale(grads, clip: float) -> torch.Tensor:
    """min(1, clip / max(‖grads‖, 1e-12))."""
    return torch.clamp_max(clip / torch.clamp_min(global_norm(grads), 1e-12), 1.0)


# -------------------------------------------------------------------- AdamW
def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, grad_clip)
        lr_t = lr * (schedule(step) if schedule else 1.0)
        t = step.float() + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            upd.add_(weight_decay * p.float())
            p.copy_(p.float() - upd.mul_(lr_t))
        return params, state

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------- Adafactor
def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern)."""

    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return tree_map(leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr * (schedule(step) if schedule else 1.0)
        states = []  # the {vr, vc} or {v} dict under each param leaf
        tree_map(lambda _, s: states.append(s), params, state)
        for p, g, s in zip(tree_leaves(params), tree_leaves(grads), states):
            g = g.float()
            g2 = g.square() + eps
            if p.dim() >= 2:
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(-2))
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp_min(vr.mean(-1, keepdim=True), eps))
                u = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"])
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.float()
            p.copy_(pf - lr_t * (u + weight_decay * pf))
        return params, state

    return Optimizer("adafactor", init, update, factored=True)


# ---------------------------------------------------------- SGD + momentum
def sgd_momentum(lr: float = 0.1, momentum: float = 0.9, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"mom": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, grad_clip) if grad_clip else 1.0
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["mom"])):
            m.mul_(momentum).add_(g.float() * scale)
            p.copy_(p.float() - lr * m)
        return params, state

    return Optimizer("sgd", init, update)


# ----------------------------------------------------------- lr schedules
def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup from 0 at step 0, then cosine decay to ``min_frac``."""
    def fn(step):
        s = step.float()
        warm = torch.clamp_max(s / max(warmup, 1), 1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return fn


def for_config(cfg, total_steps: int = 10000) -> Optimizer:
    """Per-arch default: Adafactor for the ≥300B MoEs (state bytes), AdamW
    elsewhere."""
    sched = cosine_schedule(min(200, total_steps // 10), total_steps)
    if cfg.name in ("grok-1-314b", "jamba-1.5-large-398b"):
        return adafactor(lr=1e-2, schedule=sched)
    return adamw(lr=3e-4, schedule=sched)


# ------------------------------------------------------------------ ZeRO-1
def zero1_extend_spec(spec: PartitionSpec, shape, mesh, dp_axes) -> PartitionSpec:
    """Extend a state leaf's PartitionSpec with dp axes on the first
    unsharded dim divisible by the dp size."""
    axes = mesh_shape(mesh)
    dp = tuple(a for a in dp_axes if a in axes)
    if not dp:
        return spec
    dp_size = math.prod(axes[a] for a in dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, e in enumerate(entries):
        if e is None and shape[i] % dp_size == 0 and shape[i] > 0:
            entries[i] = dp if len(dp) > 1 else dp[0]
            break
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def zero1_state_specs(opt: Optimizer, param_spec_tree, abstract_params, mesh, dp_axes):
    """PartitionSpec tree for optimizer state under ZeRO-1 (Adafactor's
    factored ``vr``/``vc`` take the param spec without its last or
    second-to-last entry, unextended)."""
    flat_sp = tree_leaves(param_spec_tree, is_leaf=is_spec)
    flat_ab = tree_leaves(abstract_params)

    def rebuild(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), param_spec_tree, is_leaf=is_spec)

    if opt.name in ("adamw", "sgd"):
        t = rebuild([zero1_extend_spec(sp, ab.shape, mesh, dp_axes)
                     for sp, ab in zip(flat_sp, flat_ab)])
        return {"m": t, "v": t} if opt.name == "adamw" else {"mom": t}
    if opt.name == "adafactor":
        def leaf(sp, ab):
            if ab.dim() >= 2:
                entries = list(sp) + [None] * (ab.dim() - len(sp))
                return {"vr": PartitionSpec(*entries[:-1]),
                        "vc": PartitionSpec(*(entries[:-2] + entries[-1:]))}
            return {"v": zero1_extend_spec(sp, ab.shape, mesh, dp_axes)}

        return rebuild([leaf(sp, ab) for sp, ab in zip(flat_sp, flat_ab)])
    raise ValueError(opt.name)
