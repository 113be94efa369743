"""Bridge from the JAX package's parameter tree to the port's.

``from_jax_params`` takes the JAX tree as numpy arrays (the caller runs
``jax.device_get``), so the port never imports jax. Both layouts carry
over as they are: ``{"scan": period}`` with leaves stacked over the
periods, and ``{"unroll": (layer, …)}``. Every leaf is checked against the
port's own spec for the same config.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import build_model
from repro_torch.models.schema import is_spec
from repro_torch.tree import tree_map


def from_jax_params(tree, cfg, *, device="cuda"):
    """JAX param tree (nested dict/tuple of numpy arrays) → the port's
    param tree on ``device``, in ``cfg.param_dtype``."""
    spec = build_model(cfg).spec()

    def leaf(s, arr):
        t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
        if tuple(t.shape) != s.shape:
            raise ValueError(f"leaf shape {tuple(t.shape)} != spec {s.shape}")
        return t.to(device=device, dtype=s.dtype or cfg.param_dtype)

    return tree_map(leaf, spec, tree, is_leaf=is_spec)
