"""Wrapper of the Hopper flash-attention forward (``csrc/flash_attention.cu``).

It replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``_fa_kernel``). The kernel reads the model layout in place through
strides, with no copy: q (B, S, KV, G, D) is seen as (B, S, H, D) with
H = KV·G, so head h reads kv head h // G; k/v are (B, S, KV, D). A tensor
whose last dimension is not contiguous, whose (KV, G) pair does not merge,
or whose strides (or, on the card, start) are not 16-byte multiples is
refused with a ValueError, on either device, so that the CPU runs of the
model check the layout that the card needs.

The bf16 kernel loads q, k and v by TMA through tensor maps that it
builds over that layout from these strides (rank 4: D, heads, S, B); the
f32 kernel (3xTF32 products on the tensor cores) walks the same strides
with ``cp.async`` and vector loads. A dim of size 1 is never stepped, and
is given a stride of 16 bytes, as TMA needs. Neither limits B·H.

Head dims 64, 96 and 128 are taken; the bf16 kernel loads a row of 96 as
three 32-column boxes, with no padding columns and no copy here.

A CPU tensor takes the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches the kernel or raises. The kernel is a forward only, as the
Pallas kernel is (no ``custom_vjp``): its output has no gradient, so a
call while autograd records through q, k or v is refused with a
ValueError on either device. The model's train path runs the
differentiable twin ``models.layers._flash_attention_qchunked`` instead.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128)


def takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes q, k and v of this head dim, all three in
    this dtype (the model's dispatch asks before it calls)."""
    return head_dim in _HEAD_DIMS and dtype in _DTYPES


# fa_forward's C signature, the stream last
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _walk(t: torch.Tensor):
    """The (b, s, h) element strides of (B, S, heads…, D), or None where
    the kernel cannot walk the tensor in place."""
    vec = 16 // t.element_size()
    st = [vec if n == 1 else s for n, s in zip(t.shape, t.stride())]
    if st[-1] != 1:
        return None
    if t.dim() == 5:  # q: (B, S, KV, G, D) with h = kv·G + g
        G = t.shape[3]
        if t.shape[2] > 1 and G > 1 and st[2] != G * st[3]:
            return None
        hs = st[3] if G > 1 else st[2]
    else:  # k/v: (B, S, KV, D)
        hs = st[2]
    strides = (st[0], st[1], hs)
    if any(s % vec for s in strides):
        return None
    return strides


def _strides(name: str, t: torch.Tensor):
    """The strides the kernel walks ``t`` by; raises if it cannot."""
    strides = _walk(t)
    if strides is None or (t.device.type == "cuda" and t.data_ptr() % 16):
        raise ValueError(
            f"flash_attention: {name} of shape {tuple(t.shape)}, strides "
            f"{t.stride()} is a layout the kernel cannot walk in place (last "
            "dim contiguous, (KV, G) merged, 16-byte strides and start)")
    return strides


def flash_attention(q, k, v, *, causal=True, softcap=0.0, scale=None):
    """GQA flash attention in the model layout: q (B,Sq,KV,G,D), k/v
    (B,Sk,KV,D) → (B,Sq,KV,G,D) in q's dtype. Causal masking assumes q and
    k both start at position 0; Sq and Sk may be any lengths. The logits
    are q·k times ``scale`` (None: 1/√D). DTensors take the op's sharding
    strategy (``register_sharding_strategy``, which ``sharding.use_rules``
    calls on a DeviceMesh)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_attention is a forward-only kernel: q, k or v "
                         "requires grad; train through "
                         "models.layers._flash_attention_qchunked")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_op(q, k, v, bool(causal), float(softcap), float(scale))


def _check(q, k, v):
    """Shapes and layouts the kernel takes (on every device, fake included);
    returns each tensor's walk strides."""
    B, Sq, KV, G, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (KV, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit (B,S,KV,G,D)/(B,S,KV,D)")
    return _strides("q", q), _strides("k", k), _strides("v", v)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       softcap: float, scale: float) -> torch.Tensor:
    """The registered op: the plain version on CPU tensors, the kernel on
    CUDA tensors (or a ValueError); ``register_fake`` gives its output's
    shape to ``FakeTensorMode`` and the meta device."""
    qs, ks, vs = _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                       scale=scale).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, Sq, KV, G, D = q.shape
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all three alike")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {_HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    Sk = k.shape[1]
    out = torch.empty((B, Sq, KV, G, D), dtype=q.dtype, device=q.device)
    os_ = _strides("out", out)
    build.launch("flash_attention", "fa_forward", _ARGTYPES, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 B, KV * G, KV, Sq, Sk, D, *qs, *ks, *vs, *os_, float(scale),
                 float(softcap), int(bool(causal)))
    return out


@flash_attention_op.register_fake
def _(q, k, v, causal, softcap, scale):
    _check(q, k, v)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, softcap, *args, **kwargs) -> int:
    """QKᵀ and PV of every head, the causal half where masked (the
    reference's accounting), for ``FlopCounterMode`` and the dry run."""
    B, Sq, KV, G, D = q_shape
    area = Sq * k_shape[1] * (0.5 if causal else 1.0)
    return int(4 * B * KV * G * D * area)


def register_sharding_strategy() -> None:
    """Give DTensor the op's sharding strategy (again: it replaces the
    entry; the module imports without ``torch.distributed``). Batch and
    kv-head dims may be sharded (each output row reads its own batch row
    and kv head); the q-group dim too, with k/v replicated (the q_per_kv
    rule of an arch whose KV heads do not divide the model axis);
    sequence and head_dim stay whole, as the reference's ``lac`` calls
    around the attention allow."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _strategy(q, k, v, causal, softcap, scale):
        r = Replicate()
        return [([r], [r, r, r, None, None, None])] + [
            ([Shard(d)], [Shard(d), Shard(d), Shard(d), None, None, None]) for d in (0, 2)
        ] + [([Shard(3)], [Shard(3), r, r, None, None, None])]
