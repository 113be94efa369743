"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card. They repeat the kernels' arithmetic
in the most direct form (materialised scores, a stable sort) and are no
yardstick of speed.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, softcap=0.0):
    """q (B,Sq,KV,G,D), k/v (B,Sk,KV,D) → (B,Sq,KV,G,D) in q's dtype.

    Scores materialised in f32, scaled by 1/√D, tanh-softcapped, causally
    masked (q and k both start at position 0), softmaxed over the keys."""
    B, Sq, KV, G, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
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


def flash_attention_check(out, q, k, v, *, causal=True, softcap=0.0):
    """Errors of ``out``, a kernel's result on (q, k, v), against
    ``flash_attention_ref`` on the same values in f32: ``max_abs_err``,
    ``rel_err`` = ‖out − ref‖_F / ‖ref‖_F, and ``row_rel_err``, the largest
    such ratio over the rows of D values. Returns (errors, within tolerance)."""
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                               softcap=softcap)
    d = out.float() - want
    rows = d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    errs = {"max_abs_err": d.abs().max().item(),
            "rel_err": (d.norm() / want.norm().clamp_min(1e-30)).item(),
            "row_rel_err": rows.max().item()}
    if out.dtype == torch.float32:
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
