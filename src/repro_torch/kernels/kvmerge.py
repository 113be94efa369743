"""Wrapper of the Hopper merge-path merge (``csrc/merge.cu``).

It replaces the Pallas bitonic merge ``src/repro/kernels/kvmerge.py``
(``_bitonic_merge_kernel``) and the JAX wrapper's padding and tiling
(``src/repro/kernels/ops.py:44-125``): the kernel takes runs of any
lengths, so one launch covers every call.

A CPU tensor takes the plain version (``ref.merge_sorted_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (the count a run reads to show that
# its path went through the kernel)
LAUNCHES = 0

_KEY_DTYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


def _fn():
    lib = build.load("merge")
    fn = lib.merge_sorted
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Merge two ascending (key, payload) runs of any lengths. Keys int32,
    uint32 or float32 (``+inf`` allowed); payloads any 32-bit dtype. Ties
    take a first. Returns (keys, vals) of length len(a) + len(b)."""
    for t in (a_keys, a_vals, b_keys, b_vals):
        if t.dim() != 1:
            raise ValueError(f"runs are 1-D, got shape {tuple(t.shape)}")
    if a_keys.shape != a_vals.shape or b_keys.shape != b_vals.shape:
        raise ValueError("each run needs one payload per key")
    if a_keys.dtype != b_keys.dtype or a_keys.dtype not in _KEY_DTYPES:
        raise ValueError(f"key dtypes {a_keys.dtype}/{b_keys.dtype}: need one "
                         f"of {sorted(map(str, _KEY_DTYPES))}, alike")
    if a_vals.dtype != b_vals.dtype or a_vals.element_size() != 4:
        raise ValueError("payloads must share one 32-bit dtype")
    dev = a_keys.device
    if any(t.device != dev for t in (a_vals, b_keys, b_vals)):
        raise ValueError("all four runs must lie on one device")
    if dev.type == "cpu":
        return ref.merge_sorted_ref(a_keys, a_vals, b_keys, b_vals)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted runs on cuda or cpu, not {dev}")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    out_k = torch.empty(na + nb, dtype=a_keys.dtype, device=dev)
    out_v = torch.empty(na + nb, dtype=a_vals.dtype, device=dev)
    if na + nb == 0:
        return out_k, out_v
    ak, av, bk, bv = (t.contiguous() for t in (a_keys, a_vals, b_keys, b_vals))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(ak.data_ptr(), av.data_ptr(), na, bk.data_ptr(),
                    bv.data_ptr(), nb, out_k.data_ptr(), out_v.data_ptr(),
                    _KEY_DTYPES[a_keys.dtype], stream)
    if err != 0:
        raise RuntimeError(f"merge kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out_k, out_v
