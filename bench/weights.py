"""Random weights from a seed, made on the device in the dtype they are
served in, in a few large calls.

The tree and its leaves' shapes are the program's abstract parameters;
the values are the benchmark's own: one normal draw for every leaf in
one flat buffer, each leaf a view of it, a weight matrix scaled to
N(0, 1/fan_in) and a norm scale to 1 + N(0, 0.1²), so that the check sees
every norm's weight. The same tensors go to the program and to the plain
reference.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

ALIGN = 64  # elements between leaves: 128-byte starts in bf16
SCALE_SD = 0.1  # spread of the norm scales about 1


def _leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, values: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,)) for i, v in enumerate(tree))
    return values[path]


def fan_in(path: tuple, shape: Tuple[int, ...], stacked: bool) -> int:
    """Inputs a weight's output sums over. ``stacked``: a leading layer
    axis. The attention output (KV, G, hd, d) sums over its three head
    axes; the embedding table is a lookup, scaled to unit rows."""
    core = shape[1:] if stacked else shape
    name = path[-1]
    if name == "embed":
        return 1
    if name == "wo" and "attn" in path:
        return math.prod(core[:-1])
    return core[0]


def is_norm_scale(path: tuple) -> bool:
    return path[-1] == "scale" and len(path) >= 2


def make(abstract_params, seed: int, device, dtype=torch.bfloat16,
         fan_in: Callable[[tuple, Tuple[int, ...], bool], int] = fan_in):
    """Parameters with the tree and shapes of ``abstract_params`` (meta
    tensors), on ``device``, in ``dtype``, drawn from ``seed``.
    ``fan_in(path, shape, stacked)`` sets each matrix's scale: a plain
    reference module may give its own."""
    leaves = _leaves(abstract_params)
    offsets, n = {}, 0
    for p, t in leaves:
        offsets[p] = n
        n += -(-t.numel() // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, dtype=dtype, device=device, generator=gen)
    values = {}
    for p, t in leaves:
        leaf = flat[offsets[p]:offsets[p] + t.numel()].view(t.shape)
        if is_norm_scale(p):
            leaf.mul_(SCALE_SD).add_(1.0)
        else:
            leaf.mul_(1.0 / math.sqrt(fan_in(p, tuple(t.shape), "scan" in p)))
        values[p] = leaf
    return _rebuild(abstract_params, values)



def with_unit_scales(params):
    """``params`` with every norm scale 1 and the matrices shared: the
    fault of a norm whose weight is dropped."""
    values = {p: (torch.ones_like(t) if is_norm_scale(p) else t) for p, t in _leaves(params)}
    return _rebuild(params, values)
