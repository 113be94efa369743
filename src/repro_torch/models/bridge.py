"""Bridge from the JAX package's parameter tree to the port's.

``from_jax_params`` takes the JAX tree as numpy arrays (the caller runs
``jax.device_get``), so the port never imports jax. Both layouts carry
over as they are: ``{"scan": period}`` with leaves stacked over the
periods, and ``{"unroll": (layer, …)}``. Every leaf is checked against the
port's own spec for the same config. ``from_jax_state`` carries a whole
train state over: params, the optimizer's moment trees (which mirror the
params) and the step count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import build_model
from repro_torch.models.schema import is_spec
from repro_torch.tree import tree_map


def from_jax_params(tree, cfg, *, device="cuda", dtype=None):
    """JAX param tree (nested dict/tuple of numpy arrays) → the port's
    param tree on ``device``, in ``dtype`` (default: the spec's dtype, else
    ``cfg.param_dtype``)."""
    spec = build_model(cfg).spec()

    def leaf(s, arr):
        t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
        if tuple(t.shape) != s.shape:
            raise ValueError(f"leaf shape {tuple(t.shape)} != spec {s.shape}")
        return t.to(device=device, dtype=dtype or s.dtype or cfg.param_dtype)

    return tree_map(leaf, spec, tree, is_leaf=is_spec)


def from_jax_state(state, cfg, *, device="cuda"):
    """JAX train state {"params", "opt", "step"} as numpy (``jax.device_get``)
    → the port's: params as ``from_jax_params``, every optimizer tree that
    mirrors the params (AdamW's m and v, SGD's mom) in f32, step an int32
    scalar tensor."""
    return {
        "params": from_jax_params(state["params"], cfg, device=device),
        "opt": {k: from_jax_params(t, cfg, device=device, dtype=torch.float32)
                for k, t in state["opt"].items()},
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                             device=device),
    }
