"""Mamba block as the Mamba-2 / SSD matmul formulation (port of
``src/repro/models/ssm.py``):

  h_t = a_t·h_{t-1} + (dt_t·B_t) ⊗ x_t      (a_t scalar per head)
  y_t = C_t·h_t + D∘x_t

Within chunks of length L the causal decay matrix M[q,s] = exp(cum_q −
cum_s) (entries ≤ 1) turns the recurrence into two matrix products; across
chunks the state is carried by a scan over the chunks, a Python loop here
where JAX runs ``jax.lax.associative_scan``. Decode runs the recurrence
one token at a time. The JAX module has no Pallas kernel. A forward-only
prefill on the card whose shapes ``ops.ssd_takes`` accepts (bf16, P 64, N
64 or 128, chunks of 256) runs the Hopper kernel ``ops.ssd_scan`` in place
of ``ssd_chunked`` and the D skip (``kernels/csrc/ssd.cu``: the same
arithmetic in f32 grade, y rounded once to bf16); everything else runs
``ssd_chunked``.

``MambaConfig.conv_bias`` (the port's own) adds a bias ``conv_b`` after
the depthwise conv. Spans: ``mamba.proj`` (the five in-projections),
``mamba.conv``, ``mamba.ssd`` (the scan or the decode step and the D
skip) and ``mamba.out`` (the gated norm and the out-projection).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding import lac, lac_grad, per_shard
from repro_torch.spans import span


def mamba_dims(cfg):
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    H = d_inner // mc.head_dim
    return d_inner, H, mc.d_state, mc.head_dim


def mamba_spec(cfg) -> dict:
    mc = cfg.mamba
    d = cfg.d_model
    di, H, N, P = mamba_dims(cfg)
    spec = {
        "wz": ParamSpec((d, di), ("embed", "inner")),
        "wx": ParamSpec((d, di), ("embed", "inner")),
        "wB": ParamSpec((d, N), ("embed", "state")),
        "wC": ParamSpec((d, N), ("embed", "state")),
        "wdt": ParamSpec((d, H), ("embed", "inner")),
        "dt_bias": ParamSpec((H,), ("inner",), init="zeros"),
        "A_log": ParamSpec((H,), ("inner",), init="ones"),
        "Dskip": ParamSpec((H,), ("inner",), init="ones"),
        "conv": ParamSpec((mc.d_conv, di + 2 * N), ("conv", "inner"), init="identity_conv"),
        "gnorm": ParamSpec((di,), ("inner",), init="ones"),
        "wo": ParamSpec((di, d), ("inner", "embed")),
    }
    if mc.conv_bias:
        spec["conv_b"] = ParamSpec((di + 2 * N,), ("inner",), init="zeros")
    return spec


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. xBC (B,S,Ch), w (W,Ch), state (B,W-1,Ch) for
    decode. Returns (out (B,S,Ch), new_state)."""
    W = w.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, xBC], 1)  # (B, S+W-1, Ch)
    out = sum(xp[:, i: i + xBC.shape[1], :] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return out, new_state


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _cumsum_chunk(a: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over axis 2 of (B,nc,L,H), as a product with the
    lower-triangular ones matrix: the same sums, and a CUDA kernel that
    ``torch.use_deterministic_algorithms`` accepts (a floating-point
    ``torch.cumsum`` on the card has none)."""
    L = a.shape[2]
    tri = torch.ones((L, L), dtype=a.dtype, device=a.device).tril()
    return torch.einsum("qs,bcsh->bcqh", tri, a)


def ssd_chunked(x, dt, a_log, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x (B,S,H,P)  dt (B,S,H)  a_log = dt * A ≤ 0 (B,S,H)
    Bm, Cm (B,S,N) (single group shared across heads)
    Returns (y (B,S,H,P) f32, h_last (B,H,N,P) f32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = S // L
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")

    xb = (x * dt[..., None]).float()  # dt-scaled input
    xc = xb.reshape(Bsz, nc, L, H, P)
    ac = a_log.reshape(Bsz, nc, L, H).float()
    Bc = Bm.reshape(Bsz, nc, L, N).float()
    Cc = Cm.reshape(Bsz, nc, L, N).float()

    cum = _cumsum_chunk(ac)  # (B,nc,L,H) decreasing
    # ---- intra-chunk: M[q,s] = exp(cum_q - cum_s) for q >= s (≤ 1), laid
    # out (B,nc,H,q,s) so that the product with x is a batched matmul
    G = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)  # (B,nc,L,L)
    cumh = cum.permute(0, 1, 3, 2)  # (B,nc,H,L)
    dif = cumh[..., :, None] - cumh[..., None, :]  # (B,nc,H,q,s)
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # clamp the exponent INSIDE the mask: masked dif is positive-huge and
    # exp(dif)=inf would NaN the backward (0-cotangent x inf)
    dif = torch.where(mask, dif, 0.0)
    M = torch.where(mask, torch.exp(dif), 0.0) * G[:, :, None]  # (B,nc,H,q,s)
    y_intra = (M @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (B,nc,q,H,P)

    # ---- chunk states: S_c = Σ_s exp(cum_end - cum_s)·B_s ⊗ xb_s
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,L,H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, decay_end, xc)  # (B,nc,H,N,P)

    # ---- cross-chunk recurrence: a scan over the chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H) total decay per chunk
    acc_a, acc_s = [chunk_decay[:, 0]], [states[:, 0]]  # inclusive, h0 = 0
    for c in range(1, nc):
        acc_a.append(acc_a[-1] * chunk_decay[:, c])
        acc_s.append(acc_s[-1] * chunk_decay[:, c, :, None, None] + states[:, c])
    acc_a, acc_s = torch.stack(acc_a, 1), torch.stack(acc_s, 1)
    h_prev = torch.cat([torch.zeros_like(acc_s[:, :1]), acc_s[:, :-1]], 1)  # entering each chunk
    if h0 is not None:
        tot = torch.cat([torch.ones_like(acc_a[:, :1]), acc_a[:, :-1]], 1)
        h_prev = h_prev + h0[:, None] * tot[..., None, None]

    # ---- inter-chunk output: y_q += C_q · (exp(cum_q)·h_prev)
    decay_in = torch.exp(cum)  # decay from chunk start to q
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, decay_in, h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    h_last = acc_s[:, -1]
    if h0 is not None:
        h_last = h_last + h0 * acc_a[:, -1][..., None, None]
    return y, h_last


def ssd_scan_flops(B, S, H, P, N, chunk) -> float:
    """Analytic FLOPs of the cross-chunk scan's combines (an upper bound
    per pass); the heavy products are outside it."""
    nc = max(S // chunk, 1)
    return 2.0 * B * nc * H * N * P


# logical axes of the scan's tensors: x (B,S,H,P), dt (B,S,H), B/C (B,S,N),
# the state (B,H,N,P)
_BSHP, _BSH = ("batch", None, "inner_heads", None), ("batch", None, "inner_heads")
_BSN, _STATE = ("batch", None, None), ("batch", "inner_heads", None, None)
_H = ("inner_heads",)


def apply_mamba(p: dict, cfg, x: torch.Tensor, *, cache: Optional[dict] = None,
                mode: str = "train") -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,D). cache = {"conv": (B,W-1,Ch), "ssm": (B,H,N,P)} for decode;
    prefill returns the cache after the last token."""
    mc = cfg.mamba
    di, H, N, P = mamba_dims(cfg)
    B, S, D = x.shape
    dt_x = x.to(cfg.compute_dtype)

    # each product's gradient returns whole along the sequence, as the
    # input is (``lac_grad``): DTensor would otherwise split it there
    with span("mamba.proj"):
        z, xin, Bm, Cm, dt_raw = (lac_grad(dt_x @ p[w].to(dt_x.dtype), "batch", "seq", None)
                                  for w in ("wz", "wx", "wB", "wC", "wdt"))

    with span("mamba.conv"):
        xBC = torch.cat([xin, Bm, Cm], -1)
        conv_state = cache.get("conv") if cache else None
        xBC, new_conv = _causal_conv(xBC, p["conv"].to(dt_x.dtype), conv_state)
        if "conv_b" in p:
            xBC = xBC + p["conv_b"].to(dt_x.dtype)
        xBC = F.silu(xBC)
        xin, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
        xin = lac(xin, "batch", "seq", "inner")

    with span("mamba.ssd"):
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
        A = -torch.exp(p["A_log"].float())  # (H,) negative

        xh = xin.reshape(B, S, H, P)
        xh = lac(xh, "batch", None, "inner_heads", None)
        if mode == "decode":
            if S != 1 or cache is None:
                raise ValueError("decode takes one token per sequence and a cache")
            h0 = cache["ssm"].float()  # (B,H,N,P)
            a = torch.exp(dt[:, 0] * A)  # (B,H)
            xb = (xh[:, 0] * dt[:, 0, :, None]).float()  # (B,H,P)
            upd = torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(), xb)
            h = h0 * a[..., None, None] + upd
            y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)[:, None]  # (B,1,H,P)
            y = y + xh.float() * p["Dskip"].float()[None, None, :, None]
            new_cache = {"conv": new_conv, "ssm": h}
        else:
            # the scan is independent per batch row and head: on DTensors it
            # runs on each device's shards, one dispatch for the whole scan
            h0 = (cache["ssm"].float(),) if cache else ()
            Dskip = p["Dskip"].float()
            if mode == "prefill" and ops.ssd_takes(xh, dt, Bm, Cm, mc.chunk):
                # the kernel: the scan and the D skip, y rounded once
                y, h_last = per_shard(
                    lambda *a: ops.ssd_scan(*a[:6], chunk=mc.chunk, h0=a[6] if h0 else None),
                    (xh, dt, A, Bm, Cm, Dskip, *h0),
                    (_BSHP, _BSH, _H, _BSN, _BSN, _H) + (_STATE,) * len(h0), (_BSHP, _STATE))
            else:
                a_log = dt * A[None, None, :]  # ≤ 0
                y, h_last = per_shard(
                    lambda *a: ssd_chunked(*a[:5], mc.chunk, *a[5:]), (xh, dt, a_log, Bm, Cm, *h0),
                    (_BSHP, _BSH, _BSH, _BSN, _BSN) + (_STATE,) * len(h0), (_BSHP, _STATE))
                y = y + xh.float() * Dskip[None, None, :, None]
            new_cache = {"conv": new_conv, "ssm": h_last} if mode == "prefill" else None
    with span("mamba.out"):
        y = y.reshape(B, S, di).to(dt_x.dtype)
        y = _gated_rmsnorm(y, z, p["gnorm"])
        y = lac(y, "batch", "seq", "inner")
        return y @ p["wo"].to(dt_x.dtype), new_cache


def mamba_cache_spec(cfg, batch: int):
    """Decode-cache (shape, dtype) leaves of a mamba layer."""
    mc = cfg.mamba
    di, H, N, P = mamba_dims(cfg)
    return {
        "conv": ((batch, mc.d_conv - 1, di + 2 * N), cfg.compute_dtype),
        "ssm": ((batch, H, N, P), torch.float32),
    }
