"""Wrappers of the Hopper merges (``csrc/merge.cu``).

They replace the Pallas bitonic merge ``src/repro/kernels/kvmerge.py``
(``_bitonic_merge_kernel``) and the JAX wrapper's padding and tiling
(``src/repro/kernels/ops.py:44-125``). ``merge_sorted`` merges two runs of
any lengths in one launch (merge path); ``merge_runs`` merges k runs laid
back to back in one launch (each key's rank), the result of folding
``merge_sorted`` over them in order.

A CPU tensor takes the plain version (``ref.merge_sorted_ref``,
``ref.merge_runs_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_KEY_DTYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


# each entry's C signature, the stream last
_ARGTYPES = {
    "merge_sorted": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p],
    "merge_runs": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p],
}


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
    build.launch("merge", "merge_sorted", _ARGTYPES["merge_sorted"], dev,
                 ak.data_ptr(), av.data_ptr(), na, bk.data_ptr(), bv.data_ptr(), nb,
                 out_k.data_ptr(), out_v.data_ptr(), _KEY_DTYPES[a_keys.dtype])
    return out_k, out_v


def _offsets(offsets, n: int) -> torch.Tensor:
    """``offsets`` (k + 1 run boundaries on the host: a sequence or a CPU
    tensor) as a CPU int64 tensor, checked: k >= 1, from 0 to ``n``,
    non-decreasing."""
    if isinstance(offsets, torch.Tensor):
        if offsets.device.type != "cpu":
            raise ValueError("offsets are run boundaries on the host")
        off = offsets.to(torch.int64).reshape(-1)
    else:
        off = torch.as_tensor(list(offsets), dtype=torch.int64)
    if off.dim() != 1 or off.numel() < 2:
        raise ValueError(f"offsets are k + 1 >= 2 run boundaries, got {off.numel()}")
    if off[0].item() != 0 or off[-1].item() != n or bool((off[1:] < off[:-1]).any()):
        raise ValueError(f"offsets must run from 0 to {n} without decreasing")
    return off


def merge_runs(keys, vals, offsets):
    """Merge k ascending (key, payload) runs laid back to back in ``keys``
    and ``vals`` (1-D, keys int32, uint32 or float32 with ``+inf`` allowed,
    payloads any 32-bit dtype), run j at ``[offsets[j], offsets[j + 1])``;
    ``offsets`` are k + 1 boundaries on the host. Ties go by run, then by
    position: the stable merge, what folding ``merge_sorted`` over the runs
    in order gives. Returns (keys, vals)."""
    if keys.dim() != 1 or keys.shape != vals.shape:
        raise ValueError(f"keys and vals are 1-D of one length, got {tuple(keys.shape)} "
                         f"and {tuple(vals.shape)}")
    if keys.dtype not in _KEY_DTYPES:
        raise ValueError(f"key dtype {keys.dtype}: need one of {sorted(map(str, _KEY_DTYPES))}")
    if vals.element_size() != 4:
        raise ValueError("payloads must be a 32-bit dtype")
    dev = keys.device
    if vals.device != dev:
        raise ValueError("keys and vals must lie on one device")
    n = keys.shape[0]
    off = _offsets(offsets, n)
    if dev.type == "cpu":
        return ref.merge_runs_ref(keys, vals, off)
    if dev.type != "cuda":
        raise ValueError(f"merge_runs runs on cuda or cpu, not {dev}")
    out_k = torch.empty(n, dtype=keys.dtype, device=dev)
    out_v = torch.empty(n, dtype=vals.dtype, device=dev)
    if n == 0:
        return out_k, out_v
    k_in, v_in = keys.contiguous(), vals.contiguous()
    off_dev = off.to(dev, non_blocking=True)
    build.launch("merge", "merge_runs", _ARGTYPES["merge_runs"], dev,
                 k_in.data_ptr(), v_in.data_ptr(), off_dev.data_ptr(), off.numel() - 1, n,
                 out_k.data_ptr(), out_v.data_ptr(), _KEY_DTYPES[keys.dtype])
    return out_k, out_v
