"""Public kernel entry points, with the signatures of ``src/repro/kernels/ops.py``.

Each runs its Hopper kernel on CUDA tensors and its plain version
(``ref.py``) on CPU tensors; nothing else chooses between the two.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kvmerge as _kv
from repro_torch.kernels import preprocess as _pp


def flash_attention(q, k, v, *, causal=True, softcap=0.0):
    """GQA flash attention. q (B,S,KV,G,D), k/v (B,S,KV,D), the model's
    native layout, read by the kernel in place."""
    return _fa.flash_attention(q, k, v, causal=causal, softcap=softcap)


def merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Merge two sorted (key, payload) runs of ANY lengths, empty runs and
    float ``+inf`` keys included. Ties take a first (stable). Returns
    (keys, vals) of length ``len(a) + len(b)``."""
    return _kv.merge_sorted(a_keys, a_vals, b_keys, b_vals)


def preprocess_image(img_chw, *, out_size=224, flip=False, mean=None, std=None, out=None):
    """Fused resize(+flip)+normalize. img (C,H,W) uint8 or f32 at any
    strides → (C,out,out) float64, bit for bit what the storage node's numpy
    path gives; written into ``out`` (any strides) when it is given."""
    return _pp.preprocess_image(img_chw, out_size=out_size, flip=flip, mean=mean,
                                std=std, out=out)
