"""Plain f32 forward of granite-4.0-h-small (HF ``GraniteMoeHybrid``): the
yardstick that decides a prefill's ``correct`` for its cell.

The model: token embedding times ``embedding_multiplier``; per layer

    x ← x + residual_multiplier · mixer(RMSNorm(x))
    x ← x + residual_multiplier · (MoE(h) + shared(h)),  h = RMSNorm(x)

with the mixer of the layer's slot in ``block_pattern``, cycled over the
layers: a Mamba-2 mixer or NoPE GQA attention; then a final RMSNorm and
the head tied to the embedding, its logits divided by ``logits_scaling``.

- Mamba-2, by its definition: in-projections z, x, B, C and dt; a causal
  depthwise conv of ``d_conv`` taps with a bias over (x, B, C), then silu;
  dt = softplus(dt + dt_bias), A = −exp(A_log) a head; the scan
  h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t ⊗ x_t, y_t = C_t·h_t + D∘x_t, run
  in its masked quadratic form, y_t = Σ_{s≤t} (C_t·B_s)·exp(Σ_{s<r≤t}
  dt_r·A)·dt_s·x_s, in blocks of query rows and of heads so that a long
  prompt fits, with the sums of dt·A in float64 (``ssm_recurrence`` is the
  recurrence itself, for the tests); then the norm gated by silu(z) (the
  norm after the gate) and the out-projection. One group of B and C.
- Attention: q/k/v projections into grouped heads (q heads ``kv · G + g``
  read kv head ``kv``), no rotary embedding, causal softmax of q·k times
  ``attention_multiplier``, in blocks of query rows; the output
  projection.
- MoE: router logits, the top k of them, gates = their softmax; each
  expert, a SwiGLU of width ``expert_d_ff``, computes every token routed
  to it (no capacity), one expert after the other; plus a shared SwiGLU
  expert of width ``shared_d_ff`` on every token.

Weights arrive as one tree in the layout the benchmark makes them in: per
layer ``ln1.scale``, ``mamba.{wz, wx, wB, wC, wdt, dt_bias, A_log, Dskip,
conv, conv_b, gnorm, wo}`` or ``attn.{wq (d, KV, G, hd), wk, wv, wo}``,
``ln2.scale``, ``moe.{router (d, E), wi, wg (E, d, f), wo (E, f, d),
shared.{wi, wg, wo}}``; ``embed`` (V, d), ``final_ln.scale``; either
stacked over the periods of ``block_pattern`` (``stack.scan``, one entry a
slot) or one dict a layer (``stack.unroll``).

Everything is computed in float32 with TF32 off, layer by layer.
``precision="fp8"`` is the control, as in ``dense_gqa``: every matmul's two
inputs rounded to float8 e4m3 and the cached k and v stored in it.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .dense_gqa import EPS, Precision, exact_f32, rms_norm

# leaves drawn at unit scale, N(0, 1): the default 1/sqrt(fan_in) would
# shrink the gated norm's scale to 0.011 and hide the Mamba path
UNIT = ("gnorm", "A_log", "dt_bias", "Dskip", "conv_b")
EXPERTS = ("wi", "wg", "wo")  # (E, in, out) under ``moe``, outside ``shared``


def fan_in(path: tuple, shape: Tuple[int, ...], stacked: bool) -> int:
    """Inputs a weight's output sums over (the benchmark draws each matrix
    at N(0, 1/fan_in)). As ``bench.weights.fan_in``, and: a routed
    expert's (E, in, out) sums over ``in``; the conv (d_conv, channels)
    over its taps; the leaves in ``UNIT`` at unit scale; the embedding,
    which is also the head, at the head's N(0, 1/d): rows of unit norm.
    (Unit-variance rows, times the embedding multiplier 12, leave the input
    token's own logit some 60 standard deviations above the rest through
    the tied head; its error then decides ``logit_err`` and no token is
    ever in doubt, so that the float8 control read no worse than the
    program: on one H100, ``logit_err`` 0.18 against 0.07-0.23, a
    ``token_gap`` of 0.)"""
    core = shape[1:] if stacked else shape
    name = path[-1]
    if name in UNIT:
        return 1
    if name == "embed":
        return core[1]
    if name == "wo" and "attn" in path:
        return math.prod(core[:-1])
    if name in EXPERTS and "moe" in path and "shared" not in path:
        return core[1]
    return core[0]


# ------------------------------------------------------------ the layers
def _layers(params: dict) -> List[Tuple[dict, Optional[int]]]:
    """(tree, period index or None) of every layer in order."""
    stack = params["stack"]
    if "scan" in stack:
        period = stack["scan"]
        n = period[0]["ln1"]["scale"].shape[0]
        return [(slot, j) for j in range(n) for slot in period]
    return [(t, None) for t in stack["unroll"]]


def _pick(tree, j: Optional[int]):
    """The layer's leaves (still in the served dtype), as views."""
    if isinstance(tree, dict):
        return {k: _pick(v, j) for k, v in tree.items()}
    return tree if j is None else tree[j]


def num_layers(params: dict) -> int:
    """Layers that hold a k and v cache: the attention layers."""
    return sum("attn" in t for t, _ in _layers(params))


def ssm_recurrence(x, dt, A, Bm, Cm, D, h0=None):
    """The SSM step by step: x (R,S,H,P), dt (R,S,H), A (H,), Bm and Cm
    (R,S,N), D (H,) → (y (R,S,H,P), the state after the last token
    (R,H,N,P)). Slow; for the tests."""
    R, S, H, P = x.shape
    N = Bm.shape[-1]
    h = x.new_zeros((R, H, N, P)) if h0 is None else h0
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)  # (R,H)
        h = h * a[..., None, None] + torch.einsum(
            "rn,rhp->rhnp", Bm[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("rn,rhnp->rhp", Cm[:, t], h) + D[:, None] * x[:, t])
    return torch.stack(ys, 1), h


def _ssm_quadratic(x, dt, A, Bm, Cm, D, prec: Precision, q_block: int, h_block: int):
    """``ssm_recurrence``'s y in its masked quadratic form."""
    R, S, H, P = x.shape
    cum = torch.cumsum(dt.double() * A.double(), 1)  # (R,S,H) Σ dt·A
    xdt = prec.act(x * dt[..., None])
    Ba, Ca = prec.act(Bm), prec.act(Cm)
    y = torch.empty_like(x)
    for q0 in range(0, S, q_block):
        q1 = min(S, q0 + q_block)
        cb = torch.einsum("rtn,rsn->rts", Ca[:, q0:q1], Ba[:, :q1])  # (R,q,s)
        later = (torch.arange(q0, q1, device=x.device)[:, None]
                 >= torch.arange(q1, device=x.device)[None, :])
        for h0 in range(0, H, h_block):
            h1 = min(H, h0 + h_block)
            seg = (cum[:, q0:q1, h0:h1].permute(0, 2, 1)[..., None]
                   - cum[:, :q1, h0:h1].permute(0, 2, 1)[:, :, None, :])  # (R,h,q,s)
            decay = torch.exp(seg.masked_fill(~later, -math.inf).float())
            del seg
            m = prec.act(cb[:, None] * decay)
            del decay
            y[:, q0:q1, h0:h1] = torch.einsum("rhts,rshp->rthp", m, xdt[:, :q1, h0:h1])
            del m
    return y + D[:, None] * x


def _ssm_state(x, dt, A, Bm):
    """The state after the last token: Σ_s exp(Σ_{s<r≤S} dt_r·A)·dt_s·B_s ⊗ x_s."""
    cum = torch.cumsum(dt.double() * A.double(), 1)
    decay = torch.exp((cum[:, -1:] - cum).float())  # (R,S,H)
    return torch.einsum("rsh,rsn,rshp->rhnp", decay * dt, Bm, x)


def mamba(p: dict, h: torch.Tensor, w: dict, prec: Precision, *, q_block: int,
          h_block: int, on_state=None) -> torch.Tensor:
    """The Mamba-2 mixer on normed h (R,S,d); ``on_state(conv, ssm)`` gets
    the conv's last d_conv − 1 inputs (R,W−1,Ch) and the SSM's state
    (R,H,N,P) after the last token."""
    mc = w["mamba"]
    R, S, d = h.shape
    N, P, W = mc["d_state"], mc["head_dim"], mc["d_conv"]
    di = mc["expand"] * d
    H = di // P
    f = {k: v.float() for k, v in p.items()}
    z = prec.mm(h, f["wz"])
    xbc = torch.cat([prec.mm(h, f[k]) for k in ("wx", "wB", "wC")], -1)  # (R,S,Ch)
    dt = F.softplus(prec.mm(h, f["wdt"]) + f["dt_bias"])  # (R,S,H)
    # causal depthwise conv: out_t = Σ_i conv[i]·in_{t−W+1+i} + bias
    conv = F.conv1d(xbc.transpose(1, 2), f["conv"].t()[:, None, :],
                    f.get("conv_b"), padding=W - 1, groups=xbc.shape[-1])
    u = F.silu(conv[..., :S].transpose(1, 2))
    x, Bm, Cm = torch.split(u, [di, N, N], -1)
    x = x.reshape(R, S, H, P)
    A = -torch.exp(f["A_log"])
    if on_state is not None:
        tail = xbc[:, max(0, S - (W - 1)):]
        tail = torch.cat([tail.new_zeros((R, W - 1 - tail.shape[1], tail.shape[2])), tail], 1)
        on_state(tail, _ssm_state(x, dt, A, Bm))
    y = _ssm_quadratic(x, dt, A, Bm, Cm, f["Dskip"], prec, q_block, h_block)
    g = y.reshape(R, S, di) * F.silu(z)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + EPS) * f["gnorm"]
    return prec.mm(g, f["wo"])


def attention(p: dict, h: torch.Tensor, w: dict, prec: Precision, block: int, on_kv,
              ordinal: int, fp8: bool) -> torch.Tensor:
    """NoPE causal GQA on normed h (R,S,d), logits times
    ``attention_multiplier``; ``on_kv(ordinal, k, v)`` gets the cache."""
    R, S, d = h.shape
    a = {k: v.float() for k, v in p.items()}
    KV, G, hd = a["wq"].shape[1:]
    q = prec.mm(h, a["wq"].reshape(d, -1)).reshape(R, S, KV, G, hd)
    k = prec.mm(h, a["wk"].reshape(d, -1)).reshape(R, S, KV, hd)
    v = prec.mm(h, a["wv"].reshape(d, -1)).reshape(R, S, KV, hd)
    if fp8:
        k, v = prec.act(k), prec.act(v)
    if on_kv is not None:
        on_kv(ordinal, k, v)
    out = torch.empty_like(q)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        s = torch.einsum("rqkgd,rskd->rkgqs", prec.act(q[:, q0:q1]), k[:, :q1])
        s = s * w["attention_multiplier"]
        mask = (torch.arange(q0, q1, device=h.device)[:, None]
                >= torch.arange(q1, device=h.device)[None, :])
        pr = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, q0:q1] = torch.einsum("rkgqs,rskd->rqkgd", prec.act(pr), v[:, :q1])
    return prec.mm(out.reshape(R, S, -1), a["wo"].reshape(-1, d))


def swiglu(h, wi, wg, wo, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, wg)) * prec.mm(h, wi), wo)


def moe(p: dict, h: torch.Tensor, w: dict, prec: Precision) -> torch.Tensor:
    """Routed experts, dropless, one after the other, plus the shared one,
    on normed h (T, d)."""
    K = w["moe"]["experts_per_token"]
    logits = prec.mm(h, p["router"].float())  # (T,E)
    top, idx = torch.topk(logits, K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    for e in range(p["router"].shape[1]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(h[rows], p["wi"][e].float(), p["wg"][e].float(), p["wo"][e].float(), prec)
        y.index_add_(0, rows, out * gates[rows, slot, None])  # a token meets e once
    s = {k: v.float() for k, v in p["shared"].items()}
    return y + swiglu(h, s["wi"], s["wg"], s["wo"], prec)


# ------------------------------------------------------------ the model
def logits(params: dict, h: torch.Tensor, precision: str = "f32", scaling: float = 1.0
           ) -> torch.Tensor:
    """The tied head over final hidden states ``h`` (…, d), already normed,
    divided by ``scaling`` (the config's ``logits_scaling``, which readings
    in standard deviations of the logits, as ``bench/control.py`` takes
    them, do not see)."""
    with exact_f32():
        return Precision(precision).mm(h, params["embed"].float().t()) / scaling


def prefill(params: dict, w: dict, tokens: torch.Tensor, *, precision: str = "f32",
            on_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
            attn_block: int = 512, all_positions: bool = False,
            on_state: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
            ssm_block: int = 1024, head_block: int = 16) -> torch.Tensor:
    """Last-position logits (R, V) float32 of prompts ``tokens`` (R, S);
    with ``all_positions`` instead the normed final hidden state of every
    position (R, S, d), for ``logits`` to read in blocks. ``on_kv(i, k,
    v)`` receives the i-th attention layer's cached k and v (R, S, KV, hd)
    float32; ``on_state(i, conv, ssm)`` the i-th Mamba layer's final conv
    inputs and SSM state. ``w`` holds the widths, ``moe``, ``mamba``,
    ``block_pattern`` and the four scalars."""
    prec = Precision(precision)
    rm = w["residual_multiplier"]
    with exact_f32():
        x = params["embed"][tokens.long()].float() * w["embedding_multiplier"]
        R, S, d = x.shape
        n_attn = n_mamba = 0
        for tree, j in _layers(params):
            p = _pick(tree, j)
            h = rms_norm(x, p["ln1"]["scale"].float())
            if "attn" in p:
                out = attention(p["attn"], h, w, prec, attn_block, on_kv, n_attn,
                                precision == "fp8")
                n_attn += 1
            else:
                i = n_mamba
                out = mamba(p["mamba"], h, w, prec, q_block=ssm_block, h_block=head_block,
                            on_state=None if on_state is None else
                            (lambda c, s, i=i: on_state(i, c, s)))
                n_mamba += 1
            x = x + rm * out
            del h, out
            h = rms_norm(x, p["ln2"]["scale"].float())
            x = x + rm * moe(p["moe"], h.reshape(R * S, d), w, prec).reshape(R, S, d)
            del h, p
        hf = rms_norm(x if all_positions else x[:, -1], params["final_ln"]["scale"].float())
        if all_positions:
            return hf
        return prec.mm(hf, params["embed"].float().t()) / w["logits_scaling"]


# ------------------------------------------------------------ the count
def _kinds(w: dict) -> List[str]:
    pat = w["block_pattern"]
    return [pat[i % len(pat)] for i in range(w["num_layers"])]


def prefill_flops(w: dict, rows: int, seq: int) -> float:
    """A prefill of ``rows`` prompts of ``seq`` tokens, counted from the
    widths whatever implements it: every matmul weight twice a token (the
    Mamba in- and out-projections, the attention projections, the router,
    the k chosen experts, the shared expert), the conv's taps, the SSD's
    chunked form at its useful work (chunks of ``chunk``: C·Bᵀ and M·x over
    the causal half, the chunk states and the state's output, 2·H·N·P a
    token each), causal attention at half area, and the head at the last
    position."""
    d, V = w["d_model"], w["vocab_size"]
    h, kv, hd = w["num_heads"], w["num_kv_heads"], w["head_dim"]
    m, mc = w["moe"], w["mamba"]
    di, N, P = mc["expand"] * d, mc["d_state"], mc["head_dim"]
    H, L = di // P, min(mc["chunk"], seq)
    attn_w = d * h * hd + 2 * d * kv * hd + h * hd * d
    mamba_w = d * (2 * di + 2 * N + H) + di * d
    moe_w = (d * m["num_experts"] + 3 * d * m["expert_d_ff"] * m["experts_per_token"]
             + 3 * d * m["shared_d_ff"])
    ssd = N * L + H * P * L + 4 * H * N * P + 2 * mc["d_conv"] * (di + 2 * N)  # a token
    tokens = rows * seq
    total = 2.0 * rows * d * V
    for kind in _kinds(w):
        total += 2.0 * tokens * moe_w
        if kind == "attn":
            total += 2.0 * tokens * attn_w + 4.0 * rows * h * hd * seq * seq / 2
        else:
            total += 2.0 * tokens * mamba_w + 1.0 * tokens * ssd
    return total
