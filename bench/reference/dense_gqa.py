"""Plain f32 forward of a dense GQA decoder: the yardstick that decides a
prefill's ``correct``.

The model: token embedding; per layer a pre-norm block of RMSNorm (eps
1e-5), q/k/v projections into grouped heads (q heads ``kv · G + g`` read
kv head ``kv``), rotary embedding on the first ``rotary_pct`` of each head
rotating interleaved pairs, causal softmax attention scaled by
1/sqrt(head_dim), an output projection and a residual add; then RMSNorm and
a SwiGLU MLP, ``(silu(h·wg) ⊙ h·wi)·wo``, and a residual add; a final
RMSNorm and the LM head. Weights arrive as one tree in the layout the
benchmark makes them in: ``embed`` (V, d), ``final_ln.scale`` (d,),
``lm_head`` (d, V) and per layer ``ln1.scale``, ``attn.wq`` (d, KV, G, hd),
``attn.wk``/``wv`` (d, KV, hd), ``attn.wo`` (KV, G, hd, d), ``ln2.scale``,
``mlp.wi``/``wg`` (d, f), ``mlp.wo`` (f, d), either stacked over the layers
(``stack.scan[0]``, a leading layer axis) or one dict a layer
(``stack.unroll``).

Everything is computed in float32 with TF32 off, layer by layer, with
attention in blocks of query rows, so that the largest prompts of a cell
fit beside its weights. ``precision="fp8"`` is the control: every matmul's
two inputs rounded to float8 e4m3 (a scale a row of activations and a
column of weights) and the cached k and v stored in it, the precision a
lower-precision serving path would take.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch

EPS = 1e-5
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32, restored on exit."""
    cuda_mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax of the slice maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(FP8).float() / scale


class Precision:
    """Where the reference rounds: nowhere (``f32``) or every matmul input
    and the cache (``fp8``)."""

    def __init__(self, kind: str):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, -1) if self.kind == "fp8" else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """w (in, out): one scale an output column."""
        return fp8_round(w, 0) if self.kind == "fp8" else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(w)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights as float32, from either layout."""
    stack = params["stack"]
    if "scan" in stack:
        period = stack["scan"]
        if len(period) != 1:
            raise ValueError("the reference takes a period of one layer")
        return _tree_f32(period[0], lambda t: t[i])
    return _tree_f32(stack["unroll"][i], lambda t: t)


def num_layers(params: dict) -> int:
    stack = params["stack"]
    if "scan" in stack:
        return stack["scan"][0]["ln1"]["scale"].shape[0]
    return len(stack["unroll"])


def _tree_f32(tree, pick):
    if isinstance(tree, dict):
        return {k: _tree_f32(v, pick) for k, v in tree.items()}
    return pick(tree).float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float, rotary_pct: float) -> torch.Tensor:
    """x (R, S, heads…, hd): the first rot dims rotated as interleaved
    pairs (2i, 2i+1) by angle pos · theta^(-2i/rot)."""
    S, hd = x.shape[1], x.shape[-1]
    rot = int(hd * rotary_pct) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float64,
                                         device=x.device) / rot))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    shape = (1, S) + (1,) * (x.dim() - 3) + (rot // 2,)
    cos, sin = ang.cos().float().reshape(shape), ang.sin().float().reshape(shape)
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.flatten(-2), x[..., rot:]], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: Precision, block: int) -> torch.Tensor:
    """q (R, S, KV, G, hd), k/v (R, S, KV, hd) → (R, S, KV, G, hd), in
    blocks of ``block`` query rows, each reading only the keys at or
    before its last row."""
    R, S, KV, G, hd = q.shape
    out = torch.empty_like(q)
    kk, vv = prec.act(k), prec.act(v)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        qb = prec.act(q[:, q0:q1])
        s = torch.einsum("rqkgd,rskd->rkgqs", qb, kk[:, :q1]) / math.sqrt(hd)
        mask = (torch.arange(q0, q1, device=q.device)[:, None]
                >= torch.arange(q1, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, q0:q1] = torch.einsum("rkgqs,rskd->rqkgd", prec.act(p), vv[:, :q1])
    return out


def logits(params: dict, h: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The LM head over final hidden states ``h`` (…, d), already normed."""
    with exact_f32():
        return Precision(precision).mm(h, params["lm_head"].float())


def prefill(params: dict, w: dict, tokens: torch.Tensor, *, precision: str = "f32",
            on_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
            attn_block: int = 512, all_positions: bool = False) -> torch.Tensor:
    """Last-position logits (R, V) float32 of prompts ``tokens`` (R, S);
    with ``all_positions`` instead the normed final hidden state of every
    position (R, S, d), for ``logits`` to read in blocks. ``on_kv(layer, k,
    v)`` receives each layer's cached k and v (R, S, KV, hd) float32 after
    rotation, as the layer makes them. ``w`` holds ``rope_theta`` and
    ``rotary_pct``."""
    prec = Precision(precision)
    with exact_f32():
        x = params["embed"][tokens.long()].float()  # (R, S, d)
        R, S, d = x.shape
        for i in range(num_layers(params)):
            p = layer_params(params, i)
            a = p["attn"]
            KV, G, hd = a["wq"].shape[1:]
            h = rms_norm(x, p["ln1"]["scale"])
            q = prec.mm(h, a["wq"].reshape(d, -1)).reshape(R, S, KV, G, hd)
            k = prec.mm(h, a["wk"].reshape(d, -1)).reshape(R, S, KV, hd)
            v = prec.mm(h, a["wv"].reshape(d, -1)).reshape(R, S, KV, hd)
            q = rope(q, w["rope_theta"], w["rotary_pct"])
            k = rope(k, w["rope_theta"], w["rotary_pct"])
            if precision == "fp8":
                k, v = prec.act(k), prec.act(v)
            if on_kv is not None:
                on_kv(i, k, v)
            o = causal_attention(q, k, v, prec, attn_block)
            del q, k, v
            x = x + prec.mm(o.reshape(R, S, -1), a["wo"].reshape(-1, d))
            del o
            h = rms_norm(x, p["ln2"]["scale"])
            m = p["mlp"]
            act = torch.nn.functional.silu(prec.mm(h, m["wg"])) * prec.mm(h, m["wi"])
            x = x + prec.mm(act, m["wo"])
            del h, act, p
        scale = params["final_ln"]["scale"].float()
        if all_positions:
            return rms_norm(x, scale)
        return prec.mm(rms_norm(x[:, -1], scale), params["lm_head"].float())
