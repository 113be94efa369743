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


def ssd_scan_ref(x, dt, A, Bm, Cm, D, *, chunk, h0=None, compute=torch.float32):
    """The Mamba-2 SSD scan and its D skip as the SSD kernel decomposes it,
    in ``compute`` (f32; f64 gives the tests a truth to measure f32 paths
    against): x (B,S,H,P), dt (B,S,H), A and D (H,), Bm and Cm (B,S,N), h0
    (B,H,N,P) or None → (y (B,S,H,P) in x's dtype, rounded once after the D
    skip; the state after the last token (B,H,N,P) in ``compute``).

    cum is the inclusive sum of dt·A (rounded to ``compute``) over each
    chunk's tokens, in f64, and enters ``compute`` only as an exponent:
    cum_end − cum_s, cum_q − cum_s, cum_q, cum_end. Per chunk: the state
    S_c = Σ_s (B_s·w_s) ⊗ x_s with w_s = dt_s·exp(cum_end − cum_s); the
    entering states by h ← h·exp(cum_end) + S_c from h0 (or 0); y_q =
    exp(cum_q)·C_q·h_prev + Σ_{s≤q} (C_q·B_s)·exp(cum_q − cum_s)·dt_s·x_s +
    D·x_q (dt on the decay side, where ``models.ssm.ssd_chunked`` scales
    x)."""
    Bsz, S, H, P = x.shape
    L = chunk
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    nc = S // L
    xf = x.to(compute).reshape(Bsz, nc, L, H, P)
    dtc = dt.to(compute).reshape(Bsz, nc, L, H)
    Bc = Bm.to(compute).reshape(Bsz, nc, L, -1)
    Cc = Cm.to(compute).reshape(Bsz, nc, L, -1)
    cum = torch.cumsum((dtc * A.to(compute)).double(), 2)  # (B,nc,L,H)
    w = dtc * torch.exp((cum[:, :, -1:] - cum).to(compute))
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, w, xf)
    h = (torch.zeros((Bsz, H, Bc.shape[-1], P), dtype=compute, device=x.device)
         if h0 is None else h0.to(compute))
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    Df = D.to(compute)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    for c in range(nc):
        cq = cum[:, c]  # (B,L,H)
        inter = torch.einsum("bqn,bhnp->bqhp", Cc[:, c], h) * torch.exp(cq.to(compute))[..., None]
        seg = torch.where(mask, (cq[:, :, None, :] - cq[:, None, :, :]).to(compute), 0.0)
        cb = torch.einsum("bqn,bsn->bqs", Cc[:, c], Bc[:, c])
        m = torch.where(mask, cb[..., None] * torch.exp(seg) * dtc[:, c, None], 0.0)
        intra = torch.einsum("bqsh,bshp->bqhp", m, xf[:, c])
        y[:, c * L:(c + 1) * L] = (inter + intra + xf[:, c] * Df[:, None]).to(x.dtype)
        h = h * torch.exp(cq[:, -1].to(compute))[..., None, None] + states[:, c]
    return y, h


# What the SSD kernel is held to, against ``models.ssm.ssd_chunked`` in f32
# plus the D skip (the path it replaces) on the same inputs: y within one
# bf16 rounding of that f32 value (half a bf16 ulp of it), give or take
# 5e-4 of the tensor's rms, and the final state to a relative 1e-5
# (Frobenius). The slack covers the f32 path's own error: its sums of dt·A
# reach the thousands, and its exp(cum_q − cum_s) of two f32 sums is off by
# |cum|·2^-24 in the exponent, which puts its y up to 1e-4 of the rms away
# from an f64 evaluation at 7,680 tokens (on the CPU, 16 heads; 3e-6 of the
# state). A scan whose f32 operands enter its products in one bf16 term
# reads some 20 times this limit.
SSD_STATE_REL_TOL = 1e-5
SSD_Y_RMS_SLACK = 5e-4


def half_ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """Half a bf16 ulp of each f32 value: the most a rounding to bf16 moves it."""
    _, e = torch.frexp(v.float())  # |v| = m·2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 9)


def ssd_scan_check(y, h_last, x, dt, A, Bm, Cm, D, *, chunk, h0=None):
    """Errors of a kernel's (y, h_last) against ``ssd_chunked`` in f32 plus
    the D skip: ``y_ulp_ratio``, the largest |y − want| over its limit (1 =
    one bf16 rounding), ``y_rel_err`` and ``y_changed`` (the share of
    elements that differ from the f32 path's value rounded to bf16),
    ``state_rel_err``. Returns (errors, within tolerance)."""
    from repro_torch.models.ssm import ssd_chunked

    want, want_h = ssd_chunked(x.float(), dt.float(), dt.float() * A.float(), Bm.float(),
                               Cm.float(), chunk, None if h0 is None else h0.float())
    want = want + x.float() * D.float()[None, None, :, None]
    d = (y.float() - want).abs()
    limit = half_ulp_bf16(want) + SSD_Y_RMS_SLACK * want.square().mean().sqrt()
    errs = {"y_ulp_ratio": (d / limit).max().item(),
            "y_rel_err": (d.norm() / want.norm()).item(),
            "y_changed": (y != want.to(y.dtype)).float().mean().item(),
            "state_rel_err": ((h_last.float() - want_h).norm() / want_h.norm()).item()}
    ok = errs["y_ulp_ratio"] <= 1.0 and errs["state_rel_err"] <= SSD_STATE_REL_TOL
    return errs, ok
