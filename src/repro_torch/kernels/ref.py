"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card. They repeat the kernels' arithmetic
in the most direct form (materialised scores, a stable sort, a gather) and
are no yardstick of speed.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, softcap=0.0, scale=None):
    """q (B,Sq,KV,G,D), k/v (B,Sk,KV,D) → (B,Sq,KV,G,D) in q's dtype.

    Scores materialised in f32, scaled by ``scale`` (None: 1/√D),
    tanh-softcapped, causally masked (q and k both start at position 0),
    softmaxed over the keys."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).to(q.dtype)


# What a flash kernel's output is held to, against the plain version run in
# f32 on the same input values. f32: per element. bf16: relative, over the
# whole output and over every row of D values, so that rows with small
# outputs (late causal rows average many values) are held as tightly as the
# few large early rows that fix the tensor's scale.
FLASH_F32_TOL = 2e-5
FLASH_BF16_REL_TOL = 5e-3
FLASH_BF16_ROW_REL_TOL = 1e-2


def flash_attention_check(out, q, k, v, *, causal=True, softcap=0.0, scale=None):
    """Errors of ``out``, a kernel's result on (q, k, v), against
    ``flash_attention_ref`` on the same values in f32: ``max_abs_err``,
    ``rel_err`` = ‖out − ref‖_F / ‖ref‖_F, and ``row_rel_err``, the largest
    such ratio over the rows of D values; for an f32 ``out`` also
    ``tol_ratio``, the largest |out − ref| / (atol + rtol·|ref|), which
    ``allclose`` holds to 1. Returns (errors, within tolerance)."""
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                               softcap=softcap, scale=scale)
    d = out.float() - want
    rows = d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    errs = {"max_abs_err": d.abs().max().item(),
            "rel_err": (d.norm() / want.norm().clamp_min(1e-30)).item(),
            "row_rel_err": rows.max().item()}
    if out.dtype == torch.float32:
        errs["tol_ratio"] = (d.abs() / (FLASH_F32_TOL * (1 + want.abs()))).max().item()
        ok = bool(torch.allclose(out, want, atol=FLASH_F32_TOL, rtol=FLASH_F32_TOL))
    else:
        ok = (errs["rel_err"] <= FLASH_BF16_REL_TOL
              and errs["row_rel_err"] <= FLASH_BF16_ROW_REL_TOL)
    return errs, ok


def merge_sorted_ref(a_keys, a_vals, b_keys, b_vals):
    """Concatenate both runs and sort stably by key: equal keys keep a's
    entries first, in run order. Returns (keys, vals)."""
    keys = torch.cat([a_keys, b_keys])
    vals = torch.cat([a_vals, b_vals])
    sort_keys = keys.to(torch.int64) if keys.dtype == torch.uint32 else keys
    order = torch.argsort(sort_keys, stable=True)
    return keys[order], vals[order]


def merge_runs_ref(keys, vals, offsets):
    """The k-way merge of the ascending runs ``keys[offsets[j]:offsets[j+1]]``
    by each key's rank, as the kernel computes it: element i of run r goes
    to (i - offsets[r]) + the keys at most its own in the runs before r + the
    keys below it in the runs after r (ties by run, then by position).
    ``offsets`` is a CPU int64 tensor of k + 1 boundaries. Returns (keys,
    vals)."""
    off = offsets.tolist()
    n, dev = keys.numel(), keys.device
    sort_keys = keys.to(torch.int64) if keys.dtype == torch.uint32 else keys
    lengths = torch.tensor([b - a for a, b in zip(off[:-1], off[1:])], device=dev)
    run = torch.repeat_interleave(torch.arange(len(off) - 1, device=dev), lengths)
    pos = torch.arange(n, device=dev) - torch.tensor(off[:-1], device=dev)[run]
    for j, (a, b) in enumerate(zip(off[:-1], off[1:])):
        if a == b:
            continue
        at_most = torch.searchsorted(sort_keys[a:b], sort_keys, right=True)
        below = torch.searchsorted(sort_keys[a:b], sort_keys, right=False)
        pos += torch.where(run > j, at_most, torch.where(run < j, below, 0))
    out_k, out_v = torch.empty_like(keys), torch.empty_like(vals)
    for dst, src in ((out_k, keys), (out_v, vals)):  # as raw 32-bit words
        dst.view(torch.int32)[pos] = src.view(torch.int32)
    return out_k, out_v


# The prep path's normalisation constants, float32 as numpy holds them
# (``data/preprocess.py``: float32 array times 255.0 stays float32).
PREP_MEAN = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32) * 255.0
PREP_STD = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32) * 255.0


def _bilinear_axis(n: int, out: int, device):
    """Source indices and weight along one axis, as ``bilinear_resize``
    computes them: s = ((o + 0.5) * n) / out - 0.5, i0 = clip(floor(s)),
    i1 = clip(i0 + 1), w = clip(s - i0, 0, 1) with the clamped i0. The
    divisor is a tensor on ``device``: CUDA divides by a host scalar as a
    multiplication by its reciprocal, which rounds differently."""
    s = (torch.arange(out, dtype=torch.float64, device=device) + 0.5) * n
    s = s / torch.full((), out, dtype=torch.float64, device=device) - 0.5
    i0 = torch.floor(s).to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    w = (s - i0.to(torch.float64)).clamp(0.0, 1.0)
    return i0, i1, w


def preprocess_image_ref(img_chw, *, out_size=224, flip=False, mean=None, std=None):
    """Bilinear resize (align_corners=False) of the crop ``img_chw`` (C,H,W)
    u8 or f32, flipped left-right if ``flip``, then (x - mean) / std per
    channel → (C, out, out) float64. The numpy storage-node path
    (``bilinear_resize`` then the normalisation) in the same float64
    elementwise operations in the same order, with no matmul, so that it
    gives the same bits."""
    C, h, w = img_chw.shape
    dev = img_chw.device
    mean = PREP_MEAN if mean is None else mean
    std = PREP_STD if std is None else std
    f = img_chw.to(torch.float32).to(torch.float64)  # u8 -> f32 -> f64, exact
    if flip:
        f = f.flip(-1)
    y0, y1, wy = _bilinear_axis(h, out_size, dev)
    x0, x1, wx = _bilinear_axis(w, out_size, dev)
    wy, wx = wy[:, None], wx[None, :]
    rows0, rows1 = f[:, y0], f[:, y1]
    top = rows0[:, :, x0] * (1.0 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1.0 - wx) + rows1[:, :, x1] * wx
    r = top * (1.0 - wy) + bot * wy
    m = torch.as_tensor(mean, dtype=torch.float32).to(dev, torch.float64)
    sd = torch.as_tensor(std, dtype=torch.float32).to(dev, torch.float64)
    return (r - m[:, None, None]) / sd[:, None, None]


def preprocess_batch_ref(packed, desc, out, *, mean=None, std=None):
    """``preprocess_image_ref`` of every crop that a row of ``desc`` (byte
    offset, h, w, C, flip, slot; a CPU int64 table) finds in the uint8
    buffer ``packed``, HWC, written into its slot of the (n, S, S, C)
    batch ``out``. Returns ``out``."""
    S = out.shape[1]
    for off, h, w, C, flip, slot in desc.tolist():
        crop = packed[off:off + h * w * C].view(h, w, C).permute(2, 0, 1)
        out[slot] = preprocess_image_ref(crop, out_size=S, flip=bool(flip), mean=mean,
                                         std=std).permute(1, 2, 0)
    return out
