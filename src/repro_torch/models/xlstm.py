"""xLSTM blocks (arXiv:2405.04517; port of ``src/repro/models/xlstm.py``):
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory, a true
recurrence with exponential gating).

mLSTM runs in a stabilised chunkwise-parallel form, a Python loop over
chunks of ``MLSTM_CHUNK`` where JAX runs ``lax.scan``; the pair weights have
non-positive exponents by construction of the running stabiliser. Decode
runs the recurrence one token at a time. sLSTM is an RNN with
block-diagonal recurrent weights, a loop over time. Both declare their scan
FLOPs to ``accounting.add_scan_flops``, as the JAX package does.

The in-chunk cumulative sum is a product with a lower-triangular ones
matrix: the same sums, and a CUDA kernel that
``torch.use_deterministic_algorithms`` accepts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.accounting import add_scan_flops
from repro_torch.models.layers import NEG_INF, gelu
from repro_torch.models.schema import ParamSpec
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding import lac, lac_grad, lac_split, per_shard

MLSTM_CHUNK = 64


# ------------------------------------------------------------------ mLSTM
def _mlstm_dims(cfg):
    di = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)
    return di, cfg.num_heads, di // cfg.num_heads


def mlstm_spec(cfg) -> dict:
    d = cfg.d_model
    xc = cfg.xlstm
    di, H, _ = _mlstm_dims(cfg)
    return {
        "wup": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv": ParamSpec((xc.conv_width, di), ("conv", "inner"), init="identity_conv"),
        "wq": ParamSpec((di, di), ("inner", "heads")),
        "wk": ParamSpec((di, di), ("inner", "heads")),
        "wv": ParamSpec((di, di), ("inner", "heads")),
        "wif": ParamSpec((di, 2 * H), ("inner", "heads"), scale=0.1),
        "if_bias": ParamSpec((2 * H,), ("heads",), init="zeros"),
        "gnorm": ParamSpec((di,), ("inner",), init="ones"),
        "wo": ParamSpec((di, d), ("inner", "embed")),
    }


def _mlstm_chunk_step(q, k, v, logi, logf, state):
    """One chunk. q,k,v (B,H,L,P); logi/logf (B,H,L); state (C,n,m)."""
    C0, n0, m0 = state
    L = q.shape[2]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    b = torch.einsum("bhs,qs->bhq", logf, causal.to(logf.dtype))  # cumsum over L
    # g_q = max(m_prev, cummax_{s<=q}(logi_s - b_s));  m_q = b_q + g_q
    gi = torch.cummax(logi - b, dim=-1).values
    g = torch.maximum(m0[..., None], gi)
    m = b + g
    # pair weights D[q,s] = exp(logi_s - b_s - g_q) (<= 1), causal mask
    expo = (logi - b)[:, :, None, :] - g[..., None]  # (B,H,q,s)
    expo = torch.where(causal, expo, NEG_INF)  # keep exp finite under the mask
    D = torch.where(causal, torch.exp(expo), 0.0)
    S = torch.einsum("bhqp,bhsp->bhqs", q, k)  # k pre-scaled by 1/sqrt(P)
    W = D * S
    carry = torch.exp(m0[..., None] - g)  # (B,H,L)
    num = torch.einsum("bhqs,bhsp->bhqp", W, v) + carry[..., None] * torch.einsum(
        "bhqp,bhpn->bhqn", q, C0)
    den = W.sum(-1) + carry * torch.einsum("bhqp,bhp->bhq", q, n0)
    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    # state to the end of the chunk
    gL, bL = g[..., -1], b[..., -1]
    wS = torch.exp(logi - b - gL[..., None])  # (B,H,L)
    decay = torch.exp(m0 - gL)
    C1 = torch.einsum("bhsp,bhsn->bhpn", k * wS[..., None], v) + decay[..., None, None] * C0
    n1 = torch.einsum("bhsp,bhs->bhp", k, wS) + decay[..., None] * n0
    m1 = bL + gL
    return h, (C1, n1, m1)


# logical axes of the loops' tensors: (B,S,H[,P]) activations, the state
_BSHP, _BSH = ("batch", None, "heads", None), ("batch", None, "heads")
_MLSTM_STATE = (("batch", "heads", None, None), ("batch", "heads", None), ("batch", "heads"))


def mlstm_cell(q, k, v, logi, logf, state=None, chunk: int = MLSTM_CHUNK):
    """q,k,v (B,S,H,P); logi/logf (B,S,H): the chunkwise form, a loop over
    chunks of min(chunk, S) (S must be a multiple). Returns (h (B,S,H,P),
    final_state) in f32. On DTensors the loop runs on each device's shards
    of batch and heads (``per_shard``)."""
    B, Ssz, H, P = q.shape
    L = min(chunk, Ssz)
    if Ssz % L:
        raise ValueError(f"sequence {Ssz} is not a multiple of the mLSTM chunk {L}")
    add_scan_flops(2.0 * B * H * Ssz * L * (3 * P + 2))  # QK^T + WV + state einsums
    st = tuple(state) if state is not None else ()
    h, *st = per_shard(lambda *a: _mlstm_chunks(L, *a), (q, k, v, logi, logf, *st),
                       (_BSHP,) * 3 + (_BSH,) * 2 + _MLSTM_STATE[:len(st)],
                       (_BSHP,) + _MLSTM_STATE)
    return h, tuple(st)


def _mlstm_chunks(L, q, k, v, logi, logf, *state):
    """``mlstm_cell``'s loop over chunks of L, on plain tensors; returns
    (h, C, n, m)."""
    B, Ssz, H, P = q.shape
    nc = Ssz // L

    def chunks(t):  # (B,S,H[,P]) -> (nc,B,H,L[,P]) in f32
        t = t.reshape((B, nc, L) + tuple(t.shape[2:])).float()
        return t.permute(1, 0, 3, 2, 4) if t.dim() == 5 else t.permute(1, 0, 3, 2)

    qc, kc, vc = chunks(q), chunks(k) / math.sqrt(P), chunks(v)
    lic, lfc = chunks(logi), chunks(logf)
    if not state:
        state = (
            q.new_zeros((B, H, P, P), dtype=torch.float32),
            q.new_zeros((B, H, P), dtype=torch.float32),
            torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device),
        )
    hs = []
    for c in range(nc):
        h, state = _mlstm_chunk_step(qc[c], kc[c], vc[c], lic[c], lfc[c], state)
        hs.append(h)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, Ssz, H, P)
    return (h, *state)


def mlstm_decode_step(q, k, v, logi, logf, state):
    """Single-token recurrence. q,k,v (B,H,P) in the compute dtype;
    logi/logf (B,H) and the state in f32. As in JAX, k's scaling and the
    k⊗v product stay in the compute dtype and the rest is promoted to f32."""
    C0, n0, m0 = state
    P = q.shape[-1]
    ks = k / math.sqrt(P)
    m1 = torch.maximum(logf + m0, logi)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(logi - m1)
    C1 = fp[..., None, None] * C0 + ip[..., None, None] * torch.einsum("bhp,bhn->bhpn", ks, v)
    n1 = fp[..., None] * n0 + ip[..., None] * ks
    qf = q.float()
    num = torch.einsum("bhp,bhpn->bhn", qf, C1)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n1).abs(), torch.exp(-m1))
    return num / den[..., None], (C1, n1, m1)


def apply_mlstm(p, cfg, x, *, cache=None, mode="train"):
    """Returns (y, new_cache); new_cache {"conv", "mlstm": (C, n, m)} in
    prefill and decode, else None."""
    di, H, P = _mlstm_dims(cfg)
    B, S, _ = x.shape
    up = x @ p["wup"].to(x.dtype)
    u, z = up.chunk(2, -1)
    u = lac(u, "batch", "seq", "inner")
    conv_state = cache.get("conv") if cache else None
    c, new_conv = _causal_conv(u, p["conv"].to(x.dtype), conv_state)
    c = F.silu(c)
    q, k, v = (lac_split(a @ p[w].to(x.dtype), H, "batch", "seq", "heads").reshape(B, S, H, P)
               for a, w in ((c, "wq"), (c, "wk"), (u, "wv")))
    # the gates' gradient returns whole along the sequence (``lac_grad``)
    gates = lac_grad(c @ p["wif"].to(x.dtype), "batch", "seq", None).float() + p[
        "if_bias"].float()
    logi, logf_raw = gates.chunk(2, -1)  # (B,S,H)
    logf = F.logsigmoid(logf_raw)

    st = cache.get("mlstm") if cache else None
    if mode == "decode":
        if S != 1:
            raise ValueError("decode takes one token per sequence")
        h, st = mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0], logi[:, 0], logf[:, 0], st)
        h = h[:, None]  # (B,1,H,P)
        new_cache = {"conv": new_conv, "mlstm": st}
    else:
        h, st = mlstm_cell(q, k, v, logi, logf, st)
        new_cache = {"conv": new_conv, "mlstm": st} if mode == "prefill" else None
    h = h.reshape(B, S, di).to(x.dtype)
    # group-norm per head + silu(z) output gate
    hf = h.float().reshape(B, S, H, P)
    ms = hf.square().mean(-1, keepdim=True)
    hf = (hf * torch.rsqrt(ms + 1e-5)).reshape(B, S, di)
    # constrained as it leaves the per-head layout, so that its gradient
    # comes back in a layout that splits into heads again
    hf = lac_split(hf, H, "batch", "seq", "heads")
    hf = hf * p["gnorm"].float() * F.silu(z.float())
    y = hf.to(x.dtype) @ p["wo"].to(x.dtype)
    return y, new_cache


def mlstm_cache_spec(cfg, batch: int):
    di, H, P = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "conv": ((batch, cfg.xlstm.conv_width - 1, di), cfg.compute_dtype),
        "mlstm": (((batch, H, P, P), f32), ((batch, H, P), f32), ((batch, H), f32)),
    }


# ------------------------------------------------------------------ sLSTM
def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    xc = cfg.xlstm
    H = cfg.num_heads
    dh = d // H
    df = int(d * xc.slstm_proj_factor)
    return {
        "conv": ParamSpec((xc.conv_width, d), ("conv", "embed"), init="identity_conv"),
        "wx": ParamSpec((d, 4 * d), ("embed", "inner")),  # i,f,z,o pre-acts
        "r": ParamSpec((4, H, dh, dh), (None, "heads", "head_dim", None), scale=0.7),
        "bias": ParamSpec((4 * d,), ("inner",), init="zeros"),
        "gnorm": ParamSpec((d,), ("embed",), init="ones"),
        # post-cell up/down MLP (proj factor 4/3)
        "wup": ParamSpec((d, 2 * df), ("embed", "mlp")),
        "wdown": ParamSpec((df, d), ("mlp", "embed")),
    }


def _slstm_step(p_r, hcnm, wx_t):
    """wx_t (B,4,H,dh) precomputed input pre-acts (or the same flat,
    (B,4d)); the recurrent part is block-diagonal. hcnm: (h, c, n, m),
    each (B,H,dh)."""
    h, c, n, m = hcnm
    B, H, dh = h.shape
    rec = torch.einsum("bhd,ghde->bghe", h, p_r)  # (B,4,H,dh)
    raw = wx_t.reshape(B, 4, H, dh) + rec
    it, ft, zt, ot = raw.unbind(1)
    m1 = torch.maximum(ft + m, it)
    ip = torch.exp(it - m1)
    fp = torch.exp(ft + m - m1)
    c1 = fp * c + ip * torch.tanh(zt)
    n1 = fp * n + ip
    h1 = torch.sigmoid(ot) * c1 / torch.clamp_min(n1, 1e-6)
    return (h1, c1, n1, m1)


_SLSTM_STATE = (("batch", "heads", None),) * 4


def _slstm_loop(pr, wx, *st):
    """The sLSTM recurrence over wx (B,S,4,H,dh) from the state (h, c, n,
    m), each (B,H,dh) (zero, with m at -inf, if not given), on plain
    tensors; returns (hs (B,S,H,dh), h, c, n, m)."""
    if not st:
        B, _, _, H, dh = wx.shape
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=wx.device)
        st = (z, z, z, torch.full((B, H, dh), NEG_INF, dtype=torch.float32, device=wx.device))
    outs = []
    for t in range(wx.shape[1]):
        st = _slstm_step(pr, st, wx[:, t])
        outs.append(st[0])
    return (torch.stack(outs, 1), *st)


def apply_slstm(p, cfg, x, *, cache=None, mode="train"):
    """Returns (y, new_cache); new_cache {"conv", "slstm": (h, c, n, m)} in
    prefill and decode, else None."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    B, S, _ = x.shape
    conv_state = cache.get("conv") if cache else None
    cx, new_conv = _causal_conv(x, p["conv"].to(x.dtype), conv_state)
    cx = F.silu(cx)
    wx = (cx @ p["wx"].to(x.dtype)).float() + p["bias"].float()  # (B,S,4d)
    # each step splits the 4d pre-activations into (4, H, dh): a DTensor
    # shard of the flat dim may not split so, so they are gathered once here
    wx = lac(wx, "batch", "seq", None).reshape(B, S, 4, H, dh)
    if mode == "decode" and S != 1:
        raise ValueError("decode takes one token per sequence")
    st = tuple(cache["slstm"]) if cache and "slstm" in cache else ()
    hs, *st = per_shard(_slstm_loop, (p["r"].float(), wx, *st),
                        ((None, "heads", None, None), ("batch", None, None, "heads", None))
                        + _SLSTM_STATE[:len(st)], (_BSHP,) + _SLSTM_STATE)
    if mode != "decode":
        add_scan_flops(2.0 * B * S * 4 * H * dh * dh)
    new_cache = {"conv": new_conv, "slstm": tuple(st)} if mode != "train" else None

    hf = hs.float()
    ms = hf.square().mean(-1, keepdim=True)
    hf = (hf * torch.rsqrt(ms + 1e-5)).reshape(B, S, d) * p["gnorm"].float()
    y = hf.to(x.dtype)
    a, b = (y @ p["wup"].to(x.dtype)).chunk(2, -1)
    return (gelu(a) * b) @ p["wdown"].to(x.dtype), new_cache


def slstm_cache_spec(cfg, batch: int):
    H = cfg.num_heads
    dh = cfg.d_model // H
    return {
        "conv": ((batch, cfg.xlstm.conv_width - 1, cfg.d_model), cfg.compute_dtype),
        "slstm": tuple(((batch, H, dh), torch.float32) for _ in range(4)),
    }
