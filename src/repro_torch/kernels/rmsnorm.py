"""Wrapper of the Hopper RMSNorm kernel (``csrc/rmsnorm.cu``): one pass over
x, bf16 in and out, with the plain formula's f32 arithmetic rounded once.

It replaces no TPU kernel (the JAX package leaves the norm to XLA) but the
nine PyTorch passes of ``ref.rms_norm_ref``, the RMSNorm of
``models.layers.apply_norm``, wherever ``takes`` holds; everything else
keeps the plain formula. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

x is read in place where its rows collapse to one stride (the model's
residual stream, or the head's last position ``x[:, -1:]``) with 16-byte
rows and start; another layout is copied first. y is a new contiguous
tensor of x's shape. A DTensor whose rows lie whole on every device (its
last dim neither split nor a partial sum, the scale replicated) is normed
shard by shard, so that a run under sharding rules computes what the same
run on plain tensors does; one whose rows are split keeps the plain formula.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# the widest row the kernel is built for: 32 warps of 32 lanes, 4 vectors of
# 8 values each
MAX_D = 32 * 32 * 4 * 8
SCALE_DTYPES = (torch.bfloat16, torch.float32)


def takes(device_type: str, records: bool, dtype: torch.dtype, scale_dtype: torch.dtype,
          d: int, bias: bool, rows_split: bool) -> bool:
    """Whether the kernel serves a norm of these properties: CUDA tensors
    that autograd does not record through, x in bf16, a scale in bf16 or
    f32, no bias (a LayerNorm), d a multiple of 8 up to MAX_D, and no
    DTensor whose rows or scale are split across devices."""
    return (device_type == "cuda" and not records and dtype == torch.bfloat16
            and scale_dtype in SCALE_DTYPES and not bias and d % 8 == 0 and 0 < d <= MAX_D
            and not rows_split)


def whole_rows(placements, ndim: int) -> bool:
    """Whether a DTensor of ``ndim`` dims at ``placements`` holds whole rows
    (its last dim) on every device: each placement replicated, or a split of
    another dim."""
    return all(p.is_replicate() or (p.is_shard() and p.dim % ndim != ndim - 1)
               for p in placements)


def properties(x, scale, bias=None):
    """What ``takes`` reads of a norm's input x (..., d), its scale (d,) and
    its bias (None for an RMSNorm)."""
    from torch.distributed.tensor import DTensor

    records = torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)
    rows_split = any(isinstance(t, DTensor) and not whole_rows(t.placements, t.ndim)
                     for t in (x, scale))
    return (x.device.type, records, x.dtype, scale.dtype, x.shape[-1], bias is not None,
            rows_split)


# rms_norm's C signature, the stream last
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _rows(x: torch.Tensor):
    """x as (rows, d) and its row stride: a view where the leading dims
    collapse to one stride with 16-byte rows and start, else a copy."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    stride = x2.stride(0) if x2.shape[0] > 1 else d
    if x2.stride(-1) != 1 or stride % 8 or not _aligned(x2):
        x2, stride = x2.clone(memory_format=torch.contiguous_format), d
    return x2, stride


def rms_norm(x, scale, eps: float = 1e-5):
    """x (..., d), scale (d,) → x's dtype: ``ref.rms_norm_ref``'s value, the
    sum of squares in another order."""
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, scale, eps)
    props = properties(x, scale)
    if not takes(*props):
        raise ValueError(f"rms_norm: the kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, scale {scale.dtype} (records grad: {props[1]}, "
                         f"rows split across devices: {props[6]})")
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) or isinstance(scale, DTensor):
        local = lambda t: t.to_local() if isinstance(t, DTensor) else t
        y = rms_norm(local(x), local(scale), eps)
        if not isinstance(x, DTensor):
            return y
        return DTensor.from_local(y, x.device_mesh, x.placements, shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} on {scale.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    if not (scale.is_contiguous() and _aligned(scale)):
        scale = scale.clone(memory_format=torch.contiguous_format)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    x2, stride = _rows(x)
    if x2.shape[0] == 0:
        return y
    build.launch("rmsnorm", "rms_norm", _ARGTYPES, x.device, x2.data_ptr(), stride,
                 scale.data_ptr(), int(scale.dtype == torch.float32), y.data_ptr(),
                 x2.shape[0], d, eps)
    return y
