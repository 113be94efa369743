"""Train-step factory (port of ``src/repro/train/step.py``): loss,
gradient accumulation over microbatches, optimizer update, metrics. State
is a plain tree {"params", "opt", "step"} with ``step`` an int32 scalar
tensor; the step updates params and moments in place (``optim``) and
returns the state with the next step count. Its metrics are
``train_loss``'s (ce, zloss and the MoE aux losses moe_aux and moe_z, 0
without MoE), loss and grad_norm, as the JAX step's."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.sharding import lac, replicate
from repro_torch.train.optim import Optimizer, global_norm
from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.train_loss(params, batch)

    return loss_fn


def init_state(model: Model, opt: Optimizer, gen: Optional[torch.Generator] = None,
               params: Any = None, *, device="cuda") -> Dict[str, Any]:
    """Params from ``gen`` (seed 0 on ``device`` when None) unless given."""
    if params is None:
        params = model.init(gen if gen is not None
                            else torch.Generator(device).manual_seed(0))
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): grads a list in ``tree_leaves(params)`` order,
    each in its param's dtype; loss and metrics detached. A param that the
    loss does not reach (a forward-only kernel's output has no ``grad_fn``)
    raises a ValueError naming it, rather than training with a zero
    gradient."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    if any(g is None for g in grads):
        paths = tree_leaves(tree_map_with_path(lambda path, _: "/".join(map(str, path)),
                                               params))
        cut = [p for p, g in zip(paths, grads) if g is None]
        raise ValueError(f"the loss does not reach the params {cut}: no gradient flows to them")
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(model: Model, opt: Optimizer, microbatches: int = 1,
                    grad_dtype=None):
    """grad_dtype=torch.bfloat16 casts the gradients before the update (the
    JAX package's DP wire-bytes option); the optimizer math stays f32.
    Microbatches split the batch's leading axis and accumulate f32
    gradients in a loop, the counterpart of JAX's ``lax.scan``. Under
    sharding rules the state and batch are DTensors at their plan's
    placements, and the grads are reduced once (``_reduce_grads``)."""
    loss_fn = make_loss_fn(model)

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            # a batch-sharded DTensor cannot be split into microbatches in
            # place: it is gathered (token ids, a few MB) and each microbatch
            # is sharded over the batch again as it is taken
            mb = {k: replicate(v).reshape((microbatches, v.shape[0] // microbatches)
                                          + v.shape[1:])
                  for k, v in batch.items()}
            grads, lsum, ms = None, None, []
            for i in range(microbatches):
                l, m, g = value_and_grad(loss_fn, params, {
                    k: lac(v[i], "batch", *(None,) * (v.dim() - 2)) for k, v in mb.items()})
                g = [gg.float() for gg in g]
                if grads is None:
                    grads, lsum = g, l
                else:
                    for acc, gg in zip(grads, g):
                        acc.add_(gg)
                    lsum = lsum + l
                ms.append(m)
            grads = [acc.div_(microbatches) for acc in grads]
            loss = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        if grad_dtype is not None:
            grads = [g.to(grad_dtype) for g in grads]
        grads = tree_unflatten(params, _reduce_grads(grads, opt, state))
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
        new_params, new_opt = opt.update(grads, state["opt"], params, state["step"])
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step


def _reduce_grads(grads, opt: Optimizer, state):
    """The grads at the placements of what they update. A DTensor grad is a
    partial sum over the batch's shards until here (microbatches add to it
    without a collective); it is reduced once, into the shards of the
    optimizer state it updates: ZeRO-1's reduce-scatter where the moments
    are sharded further than their params, else onto the param's."""
    from torch.distributed.tensor import DTensor

    if not grads or not isinstance(grads[0], DTensor):
        return grads
    key = {"adamw": "m", "sgd": "mom"}.get(opt.name)
    like = tree_leaves(state["opt"][key] if key else state["params"])
    return [g if tuple(g.placements) == tuple(t.placements)
            else g.redistribute(g.device_mesh, t.placements) for g, t in zip(grads, like)]


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
