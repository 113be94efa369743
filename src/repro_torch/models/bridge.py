"""Bridge from the JAX package's parameter tree to the port's.

``from_jax_params`` takes the JAX tree as numpy arrays (the caller runs
``jax.device_get``), so the port never imports jax. Both layouts carry
over as they are: ``{"scan": period}`` with leaves stacked over the
periods, and ``{"unroll": (layer, …)}``, whatever the layers hold
(attention, mamba, mLSTM or sLSTM with its (4, H, dh, dh) recurrent
weights, a decoder's cross-attention, a dense MLP or MoE experts), and an
encoder–decoder's ``enc_stack`` and ``enc_ln``. Every leaf is checked
against the port's own spec for the same config. ``from_jax_state``
carries a whole train state over: params, the optimizer's moment trees
(which mirror the params) and the step count. ``from_jax_cache`` carries a
decode cache over (attention KV buffers and a decoder's cross K/V, mamba
conv and SSM states, the xLSTM blocks' conv states and state tuples), each
leaf checked against ``Model.cache_spec`` in shape and dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as T
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


def _host_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_jax_cache(tree, cfg, batch: int, max_len: int, *, device="cuda"):
    """JAX decode cache {"stack", "pos"} as numpy (``jax.device_get``) →
    the port's on ``device``. Each leaf must have the shape and dtype that
    the port's ``cache_spec(batch, max_len)`` gives it."""
    spec = build_model(cfg).cache_spec(batch, max_len)

    def leaf(s, arr):
        shape, dtype = s
        t = _host_tensor(arr)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"cache leaf {tuple(t.shape)} {t.dtype} != spec {shape} {dtype}")
        return t.to(device)

    return tree_map(leaf, spec, tree, is_leaf=T._is_shape_dtype)
