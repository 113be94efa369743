"""Public kernel entry points, with the signatures of ``src/repro/kernels/ops.py``.

Each decides by device only: its plain version (``ref.py``) on CPU
tensors, its Hopper kernel on CUDA tensors, or a raise where the kernel
does not take the call. Whether a call comes here is the model's choice,
in one place per kernel: ``models.layers.attention_path`` picks the
attention path of each call (this op, the chunked twin or einsum), and
``models.ssm.apply_mamba``, through ``ssd_takes``, picks the SSD scan's,
and ``models.layers.apply_norm``, through ``rms_norm_takes``, the norm's.

``ssd_scan`` replaces no TPU kernel: it is the Mamba-2 mixer's chunked
scan with its D skip (``src/repro/models/ssm.py`` ``ssd_chunked``, plain
jnp there), for the calls ``ssd_takes`` accepts. ``rms_norm`` replaces
none either: it is ``apply_norm``'s RMSNorm (``ref.rms_norm_ref``, nine
PyTorch passes) in one, for the calls ``rms_norm_takes`` accepts.

``merge_runs`` and ``preprocess_batch`` compute nothing the JAX package
does not: ``merge_runs`` is the fold of ``merge_sorted`` over a fetch's
arrival runs (``src/repro/serve/kvstore.py:452-462``) and the pairwise
tree over a scan's streams (``src/repro/core/pushdown.py:462-470``);
``preprocess_batch`` is the per-image loop over a minibatch's local share
(``src/repro/data/offload_prep.py:120-127``). Each does it in one launch.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kvmerge as _kv
from repro_torch.kernels import preprocess as _pp
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd


def flash_attention(q, k, v, *, causal=True, softcap=0.0, block_q=256, block_kv=256,
                    scale=None):
    """GQA flash attention. q (B,S,KV,G,D), k/v (B,S,KV,D), the model's
    native layout, read by the kernel in place; the logits are q·k times
    ``scale`` (None: 1/√D). Forward only: raises a ValueError while
    autograd records through q, k or v.

    ``block_q`` and ``block_kv`` are the Pallas kernel's tile sizes, taken
    so that a call written for ``src/repro/kernels/ops.py`` runs here. The
    Hopper kernel picks its own tiles (128-row q tiles,
    ``csrc/flash_attention.cu``), so the result does not depend on them."""
    del block_q, block_kv
    return _fa.flash_attention(q, k, v, causal=causal, softcap=softcap, scale=scale)


def flash_takes(head_dim, dtype):
    """Whether ``flash_attention`` takes q, k and v of this head dim, all
    three in this dtype."""
    return _fa.takes(head_dim, dtype)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk, h0=None):
    """The Mamba-2 SSD scan and its D skip, forward only: x (B,S,H,P), dt
    (B,S,H) f32, A and D (H,) f32, Bm and Cm (B,S,N), h0 (B,H,N,P) f32 or
    None → (y (B,S,H,P) in x's dtype, ``ssd_chunked``'s y + D·x rounded
    once; the state after the last token (B,H,N,P) f32)."""
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)


def ssd_takes(x, dt, Bm, Cm, chunk) -> bool:
    """Whether ``ssd_scan`` runs its kernel on these operands: CUDA tensors
    that autograd does not record through, x in bf16, a head dim of 64, a
    state of 64 or 128, chunks of 256 and S a whole number of them."""
    return _ssd.takes(*_ssd.properties(x, Bm, chunk, dt, Cm))


def rms_norm(x, scale, *, eps=1e-5):
    """RMSNorm over the last dim, forward only: x (..., d) bf16, scale (d,)
    bf16 or f32 → ``ref.rms_norm_ref``'s value in bf16 (the same f32
    arithmetic, rounded once; only the order of the sum of squares differs)."""
    return _rms.rms_norm(x, scale, eps)


def rms_norm_takes(x, scale, bias=None) -> bool:
    """Whether ``rms_norm`` runs its kernel on this norm: CUDA tensors that
    autograd does not record through, x in bf16, the scale in bf16 or f32, no
    bias, d a multiple of 8 up to the kernel's widest, and rows and scale
    whole on every device where they are DTensors."""
    return _rms.takes(*_rms.properties(x, scale, bias))


def merge_sorted(a_keys, a_vals, b_keys, b_vals):
    """Merge two sorted (key, payload) runs of ANY lengths, empty runs and
    float ``+inf`` keys included. Ties take a first (stable). Returns
    (keys, vals) of length ``len(a) + len(b)``."""
    return _kv.merge_sorted(a_keys, a_vals, b_keys, b_vals)


def merge_runs(keys, vals, offsets):
    """Merge k sorted (key, payload) runs laid back to back, run j at
    ``[offsets[j], offsets[j + 1])`` (k + 1 boundaries on the host), in one
    launch. Ties go by run, then by position (stable), so the result is
    that of folding ``merge_sorted`` over the runs in order."""
    return _kv.merge_runs(keys, vals, offsets)


def preprocess_batch(packed, desc, out, *, mean=None, std=None):
    """``preprocess_image`` of every crop in ``packed`` (HWC uint8, back to
    back, with its host table ``desc``: see ``preprocess.pack_crops``) into
    its slot of the (n, S, S, C) float64 batch ``out``, in one launch."""
    return _pp.preprocess_batch(packed, desc, out, mean=mean, std=std)


def preprocess_image(img_chw, *, out_size=224, flip=False, mean=None, std=None, out=None):
    """Fused resize(+flip)+normalize. img (C,H,W) uint8 or f32 at any
    strides → (C,out,out) float64, bit for bit what the storage node's numpy
    path gives; written into ``out`` (any strides) when it is given."""
    return _pp.preprocess_image(img_chw, out_size=out_size, flip=flip, mean=mean,
                                std=std, out=out)
