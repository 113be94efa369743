"""Logical-axis sharding (port of ``src/repro/sharding.py``): rules mapping
logical axes → mesh axes.

Model code annotates parameters (``ParamSpec.axes``) and activations
(``lac``) with *logical* axis names. A :class:`ShardingRules` object — chosen
per (config, mesh, shape cell) — resolves them to :class:`PartitionSpec`s,
with the reference's fallbacks: an axis that does not divide its dim, or a
mesh axis already taken by an earlier dim, is left unsharded.

The mesh is anything that gives axis sizes by name: the port's
:class:`AbstractMesh` (name → size, no devices), enough to plan, or a
``torch.distributed.DeviceMesh`` with ``mesh_dim_names``, on which
``placements`` turns a spec into DTensor placements (the port's
``NamedSharding``) and ``lac`` redistributes a DTensor activation (the
port's ``with_sharding_constraint``). Installed via a context manager so
model code stays mesh-agnostic::

    with use_rules(rules):
        logits, _, _ = model.apply(params, batch)
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of them (the dim split over their product, the first major);
    trailing Nones dropped, as JAX's ``PartitionSpec``. ``tuple(p)``
    compares with a JAX spec."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_axes(x) -> bool:
    """Leaf predicate for logical-axes tuples (tuples of str/None)."""
    return (isinstance(x, tuple) and not isinstance(x, PartitionSpec)
            and all(e is None or isinstance(e, str) for e in x))


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes and no devices: enough to plan."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size of an :class:`AbstractMesh` or a named DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take rules")
    return dict(zip(names, mesh.shape))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("sharding_rules", default=None)


@dataclass(frozen=True)
class ShardingRules:
    mesh: object  # AbstractMesh or a DeviceMesh with mesh_dim_names
    rules: Dict[str, MeshAxes]  # logical axis -> mesh axis (or tuple / None)

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    def _mesh_size(self, ax: MeshAxes) -> int:
        if ax is None:
            return 1
        shape = self.shape
        if isinstance(ax, str):
            return shape[ax]
        return math.prod(shape[a] for a in ax)

    def spec(self, logical_axes: Sequence[Optional[str]], shape=None) -> PartitionSpec:
        """Resolve logical axes to a PartitionSpec; check divisibility if
        shape given (undersized dims fall back to replication)."""
        out, used = [], set()
        for i, name in enumerate(logical_axes):
            ax = self.rules.get(name) if name else None
            if ax is not None:
                flat = (ax,) if isinstance(ax, str) else tuple(ax)
                if any(a in used for a in flat):
                    ax = None  # mesh axis already consumed by an earlier dim
                elif shape is not None and shape[i] % self._mesh_size(ax) != 0:
                    ax = None  # not divisible -> replicate
                else:
                    used.update(flat)
            out.append(ax)
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def tree_specs(self, axes_tree, abstract_tree=None):
        """Map an axes tree (+ optional tensors aligned with it, for their
        shapes) to a PartitionSpec tree."""
        if abstract_tree is None:
            return tree_map(lambda a: self.spec(a), axes_tree, is_leaf=is_axes)
        flat_a = tree_leaves(axes_tree, is_leaf=is_axes)
        flat_s = _leaves_up_to(axes_tree, abstract_tree)
        return tree_unflatten_axes(axes_tree, [self.spec(a, tuple(s.shape))
                                               for a, s in zip(flat_a, flat_s)])

    def local_shape(self, spec: PartitionSpec, shape) -> Tuple[int, ...]:
        """Per-device shape of a tensor of ``shape`` under ``spec`` (each
        sharded dim divided by its mesh axes' product, rounded up)."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        return tuple(-(-n // self._mesh_size(e)) for n, e in zip(shape, entries))

    def placements(self, spec: PartitionSpec):
        """DTensor placements, one per mesh dim, for ``spec``: ``Shard(i)``
        on each mesh axis that tensor dim i is split over, ``Replicate()``
        on the rest. A dim split over several axes takes them in mesh order
        (the first major), which is the order JAX's specs name them in. An
        axis of size 1 splits nothing, so its placement is ``Replicate()``,
        the same layout (and one that every DTensor op can take)."""
        from torch.distributed.tensor import Replicate, Shard

        sizes = self.shape
        names = list(sizes)
        out = [Replicate() for _ in names]
        for i, e in enumerate(spec):
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {spec}: dim {i} names mesh axes {axes} out of "
                                 f"the mesh's order {tuple(names)}")
            for p in pos:
                if sizes[names[p]] > 1:
                    out[p] = Shard(i)
        return tuple(out)


def _leaves_up_to(axes_tree, tree):
    """The subtrees of ``tree`` at the positions of ``axes_tree``'s axes
    leaves (JAX's ``treedef.flatten_up_to``)."""
    out = []

    def walk(a, t):
        if is_axes(a):
            out.append(t)
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], t[k])
        else:
            for x, y in zip(a, t, strict=True):
                walk(x, y)

    walk(axes_tree, tree)
    return out


def tree_unflatten_axes(axes_tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), axes_tree, is_leaf=is_axes)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Install ``rules`` for the block. On a DeviceMesh, the plain tensors
    that the model makes itself (positions, masks, zeros) join DTensor ops
    as replicated (DTensor's implicit replication): every rank makes the same;
    and the flash op's DTensor sharding strategy, and those of the aten ops
    that DTensor has none for (``_register_strategies``), are registered,
    where DTensors first reach the model."""
    tok = _ACTIVE.set(rules)
    try:
        if rules is None or isinstance(rules.mesh, AbstractMesh):
            yield
        else:
            from torch.distributed.tensor import DTensor

            from repro_torch.kernels.flash_attention import register_sharding_strategy

            register_sharding_strategy()
            _register_strategies()
            # DTensor's ``implicit_replication()`` turns the switch off as
            # it leaves; a nested block (a recomputation inside the
            # backward of an outer one) restores what it found instead
            disp = DTensor._op_dispatcher
            was = disp._allow_implicit_replication
            disp._allow_implicit_replication = True
            try:
                yield
            finally:
                disp._allow_implicit_replication = was
    finally:
        _ACTIVE.reset(tok)


def current_rules() -> Optional[ShardingRules]:
    return _ACTIVE.get()


def lac(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Logical activation constraint — no-op without installed rules, and
    for a tensor that is not a DTensor. A DTensor is redistributed to the
    placements the rules give its logical axes (a partial sum reduced, a
    shard gathered or cut), and so is its gradient on the way back, as the
    transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent."""
    return _lac(x, logical_axes, None)


def lac_split(x: torch.Tensor, lead: int, *logical_axes: Optional[str]) -> torch.Tensor:
    """``lac`` of ``x`` whose last dim is about to be split with ``lead`` as
    its major size (heads of a flat projection): the last logical axis is
    resolved against ``lead``, not the flat size, so that a shard kept on
    that dim splits with it (DTensor cannot unflatten a shard that does
    not divide the major dim)."""
    return _lac(x, logical_axes, lead)


def split_first(t, dims):
    """``dims`` with those that DTensor ``t`` splits first, or None where
    ``t`` is not a DTensor or splits none of them: the order in which to
    flatten them. A flattened group of dims whose split dim is not the
    major one is a strided shard, whose redistributions DTensor plans by a
    graph search that grows with the mesh's rank; with the split dim major
    the flat dim is a plain shard."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    split = {p.dim for p in t.placements if isinstance(p, Shard)}
    if not split & set(dims):
        return None
    return tuple(sorted(dims, key=lambda d: d not in split))


def lac_grad(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` as it is, and its gradient on the way back at the placements
    the rules give ``logical_axes`` (a no-op where ``lac`` is). A sublayer's
    output joins a sequence-split residual stream at the stream's
    placements, while its gradient returns to the sublayer whole along the
    sequence (the all-gather of sequence parallelism's backward), where the
    sublayer's products would flatten a split sequence into a strided
    shard."""
    r = current_rules()
    if r is None or not x.requires_grad:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, None, r.placements(r.spec(logical_axes, tuple(x.shape))))


def _lac(x, logical_axes, lead):
    r = current_rules()
    if r is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    shape = tuple(x.shape) if lead is None else tuple(x.shape[:-1]) + (lead,)
    return _constrain(x, r.placements(r.spec(logical_axes, shape)))


def _constrain(x, want):
    if not x.requires_grad:
        return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)
    return _Constrain.apply(x, want, want)


class _Constrain(torch.autograd.Function):
    """A DTensor at placements ``want`` (None: as it is), and its gradient
    at ``grad_want``."""

    @staticmethod
    def forward(ctx, x, want, grad_want):
        ctx.want = grad_want
        if want is None or tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None, None


def per_shard(fn, args, in_axes, out_axes):
    """``fn(*args)``, a function whose work is independent per batch row and
    per head. Under installed rules, on DTensors, it runs once on each
    device's shards (``local_map``), so that DTensor dispatches the call
    once, not each op of a loop inside it. ``in_axes`` gives each argument's
    logical axes; each is constrained to the placements the rules give them
    (a dim that is looped over must resolve to no mesh axis). ``out_axes``
    is a tuple of logical axes per leaf of the flattened output, whose
    names take the mesh axes they took in the arguments. An argument's
    gradient comes back at its placements, except on a mesh dim where it
    is replicated and another argument is split: each shard's gradient of
    a weight is then its own rows' share, a partial sum."""
    r = current_rules()
    from torch.distributed.tensor import DTensor

    if r is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names, places = {}, []
    for a, axes in zip(args, in_axes, strict=True):
        spec = tuple(r.spec(axes, tuple(a.shape)))
        for n, e in zip(axes, spec + (None,) * len(axes)):
            if n is not None:
                names.setdefault(n, e)
        places.append(r.placements(PartitionSpec(*spec)))
    split = {i for pl in places for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = [tuple(Partial() if i in split and p == Replicate() else p
                   for i, p in enumerate(pl)) for pl in places]
    outs = tuple(r.placements(PartitionSpec(*(names.get(n) if n else None for n in axes)))
                 for axes in out_axes)
    args = [_constrain(a, pl) for a, pl in zip(args, places)]
    return local_map(fn, out_placements=outs, in_placements=tuple(places),
                     in_grad_placements=tuple(grads), device_mesh=args[0].device_mesh)(*args)


_STRATEGIES_REGISTERED = False


def _register_strategies() -> None:
    """Pointwise DTensor sharding strategies for the aten ops that the model
    reaches and DTensor has none for: ``log_sigmoid_forward`` and
    ``log_sigmoid_backward`` (``F.logsigmoid``, the mLSTM forget gate).
    Every tensor at one placement, replicated or split on any dim; the
    forward's ``buffer`` output, which a CUDA kernel leaves empty, is
    replicated there."""
    global _STRATEGIES_REGISTERED
    if _STRATEGIES_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    def alike(x):
        return [Replicate()] + [Shard(d) for d in range(len(x.shape))]

    def empty_buffer(x) -> bool:
        return x.mesh.device_type in ("cuda", "xpu")

    @register_sharding(aten.log_sigmoid_forward.default)
    def _log_sigmoid_forward(x):
        buf = empty_buffer(x)
        return [([p, Replicate() if buf else p], [p]) for p in alike(x)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        buf = empty_buffer(x)
        return [([p], [p, p, Replicate() if buf else p]) for p in alike(x)]

    _STRATEGIES_REGISTERED = True


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` redistributed to ``Replicate()`` on every mesh dim;
    anything else unchanged. The fallback before an op that DTensor has no
    sharding strategy for."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return _constrain(x, tuple(Replicate() for _ in x.placements))


# ------------------------------------------------------------ rule presets
def make_rules(mesh, cfg=None, *, cell_kind: str = "train", seq_shard: bool = False,
               zero1: bool = True) -> ShardingRules:
    """Production rule set.

    batch → (pod, data); model-parallel tensor axes → model; optimizer-state
    extra sharding handled in train/optim (ZeRO-1 over (pod,data)).

    seq_shard: shard activation seq over 'data' (context/sequence parallelism
    for prefill with tiny per-device batch).
    """
    axes = mesh_shape(mesh)
    dp: MeshAxes = ("pod", "data") if "pod" in axes else "data"
    rules: Dict[str, MeshAxes] = {
        "batch": dp,
        "cache_batch": dp,  # KV/state cache batch dim (decouplable from acts)
        "seq": ("model" if seq_shard else None),
        "embed": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": "model",  # picked up when `experts` doesn't divide
        "state": None,
        "conv": None,
        "inner": "model",  # mamba/xlstm expanded inner dim
        "inner_heads": "model",  # mamba SSD head dim (activations)
        "layers": None,
        # embedding table: vocab-sharded (local gather + mask + all-reduce)
        "vocab_table": "model",
        "embed_shard": None,
        # activation-only axes
        "residual": None,  # residual-stream feature dim
        "act_seq": None,   # residual-stream seq dim ("model" = sequence parallel)
        "kv_seq": None,    # KV-cache seq dim (decode cells shard this)
        "logit_vocab": "model",
    }
    if cfg is not None and "model" in axes:
        m = axes["model"]
        kv, g = cfg.num_kv_heads, cfg.q_per_kv
        if kv % m == 0:
            rules["kv_heads"], rules["q_per_kv"] = "model", None
        elif g % m == 0:
            # undersized KV heads (e.g. glm4 kv=2): shard the q-group dim,
            # replicate K/V heads
            rules["kv_heads"], rules["q_per_kv"] = None, "model"
        else:
            # neither divides (e.g. qwen3 kv=8,g=2 on model=16): attention
            # runs replicated over `model`; MLP/embed still shard
            rules["kv_heads"], rules["q_per_kv"] = None, None
    else:
        rules["q_per_kv"] = None
    return ShardingRules(mesh, rules)


def batch_specs(rules: ShardingRules, tree_axes):
    return rules.tree_specs(tree_axes)
