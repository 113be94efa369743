"""Parameter schema (port of ``src/repro/models/schema.py``): one tree of
:class:`ParamSpec` gives the parameters' shapes, their init, their count,
their logical axes (``axes_tree``, read by ``repro_torch.sharding``) and
their abstract stand-ins on the ``meta`` device (``abstract_tree``).
Parameters are plain nested dicts/tuples of tensors."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class ParamSpec:
    """Declares one parameter tensor.

    init kinds:
      normal    — N(0, scale/sqrt(fan_in)) with fan_in = shape[fan_in_axis]
      trunc     — normal truncated to ±3 standard deviations, stddev=scale
      zeros/ones
      identity_conv — dirac init for depthwise conv kernels
    """

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"
    scale: float = 1.0
    fan_in_axis: int = -2
    dtype: Any = None  # None → caller default

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"rank mismatch: shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def materialize(spec: ParamSpec, gen: torch.Generator, default_dtype) -> torch.Tensor:
    """One parameter on ``gen.device``, drawn from ``gen``."""
    dtype = spec.dtype if spec.dtype is not None else default_dtype
    shape, dev = spec.shape, gen.device
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if spec.init == "normal":
        fan_in = shape[spec.fan_in_axis] if len(shape) >= 2 else shape[0]
        std = spec.scale / max(float(fan_in), 1.0) ** 0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(std).to(dtype)
    if spec.init == "trunc":
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return w.mul_(spec.scale).to(dtype)
    if spec.init == "identity_conv":  # (width, channels): impulse at last tap
        w = torch.zeros(shape, dtype=torch.float32, device=dev)
        w[-1] = 1.0
        return w.to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_tree(spec_tree, gen: torch.Generator, default_dtype=torch.float32):
    """Materialise a spec tree into parameters, leaf by leaf in tree order
    from one generator (the same seed gives the same tree; the numbers
    differ from ``jax.random``'s, so parity tests bridge JAX weights)."""
    return tree_map(lambda s: materialize(s, gen, default_dtype), spec_tree,
                    is_leaf=is_spec)


def axes_tree(spec_tree):
    """The logical-axis tree (same structure, tuples of axis names)."""
    return tree_map(lambda s: s.axes, spec_tree, is_leaf=is_spec)


def abstract_tree(spec_tree, default_dtype=torch.float32):
    """Tensors on the ``meta`` device (shape and dtype, no storage), each
    in its spec's dtype or ``default_dtype``."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or default_dtype,
                                          device="meta"),
                    spec_tree, is_leaf=is_spec)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree, is_leaf=is_spec))
