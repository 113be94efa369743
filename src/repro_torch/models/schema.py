"""Parameter schema (port of ``src/repro/models/schema.py``): one tree of
:class:`ParamSpec` gives the parameters' shapes, their init and their
count. Parameters are plain nested dicts/tuples of tensors."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class ParamSpec:
    """Declares one parameter tensor.

    init kinds (those the ported architectures use):
      normal    — N(0, scale/sqrt(fan_in)) with fan_in = shape[fan_in_axis]
      zeros/ones
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
    raise ValueError(f"unknown init {spec.init!r}")


def init_tree(spec_tree, gen: torch.Generator, default_dtype=torch.float32):
    """Materialise a spec tree into parameters, leaf by leaf in tree order
    from one generator (the same seed gives the same tree; the numbers
    differ from ``jax.random``'s, so parity tests bridge JAX weights)."""
    return tree_map(lambda s: materialize(s, gen, default_dtype), spec_tree,
                    is_leaf=is_spec)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree, is_leaf=is_spec))
