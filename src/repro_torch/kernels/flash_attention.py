"""Wrapper of the Hopper flash-attention forward (``csrc/flash_attention.cu``).

It replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
(``_fa_kernel``). The kernel reads the model layout in place through
strides, with no copy: q (B, S, KV, G, D) is seen as (B, S, H, D) with
H = KV·G, so head h reads kv head h // G; k/v are (B, S, KV, D). A tensor
whose last dimension is not contiguous, whose (KV, G) pair does not merge,
or whose strides (or, on the card, start) are not 16-byte multiples is
refused with a ValueError, on either device, so that the CPU runs of the
model check the layout that the card needs.

A CPU tensor takes the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (the count a run reads to show that
# its path went through the kernel)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _fn():
    lib = build.load("flash_attention")
    fn = lib.fa_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _walk(t: torch.Tensor):
    """The (b, s, h) element strides of (B, S, heads…, D), or None where
    the kernel cannot walk the tensor in place."""
    st = [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]
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
    vec = 16 // t.element_size()
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


def flash_attention(q, k, v, *, causal=True, softcap=0.0):
    """GQA flash attention in the model layout: q (B,Sq,KV,G,D), k/v
    (B,Sk,KV,D) → (B,Sq,KV,G,D) in q's dtype. Causal masking assumes q and
    k both start at position 0; Sq and Sk may be any lengths."""
    B, Sq, KV, G, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (KV, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit (B,S,KV,G,D)/(B,S,KV,D)")
    qs, ks, vs = _strides("q", q), _strides("k", k), _strides("v", v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all three alike")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {_HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, KV, G, D), dtype=q.dtype, device=q.device)
    os_ = _strides("out", out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _DTYPES[q.dtype], B, KV * G, KV, Sq, Sk, D,
                    *qs, *ks, *vs, *os_, float(scale), float(softcap),
                    int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
