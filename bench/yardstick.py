"""The benchmark's own arithmetic: the card's peaks, a kernel's roofline
bound, the work of a prefill, a nearest-rank percentile, and the union
of device intervals. Nothing here reads the program's own accounting.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), as the
port's smoke run states them: 989 TFLOP/s bf16, 3.35 TB/s HBM.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def layer_matmul_params(w: dict) -> int:
    """Weights a token multiplies through in one dense GQA layer:
    q, k, v, o projections and a SwiGLU MLP."""
    d, h, kv, hd, f = (w["d_model"], w["num_heads"], w["num_kv_heads"], w["head_dim"],
                       w["d_ff"])
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f


def causal_attention_flops(rows: int, seq: int, heads: int, head_dim: int) -> float:
    """QKᵀ and PV over the causal half of the (seq × seq) area."""
    return 4.0 * rows * heads * head_dim * seq * seq / 2


def prefill_flops(w: dict, rows: int, seq: int) -> float:
    """A prefill of ``rows`` prompts of ``seq`` tokens: every matmul weight
    twice a token, the head at the last position only, causal attention at
    half area whatever implements it."""
    tokens = rows * seq
    dense = 2.0 * tokens * layer_matmul_params(w) * w["num_layers"]
    head = 2.0 * rows * w["d_model"] * w["vocab_size"]
    attn = causal_attention_flops(rows, seq, w["num_heads"], w["head_dim"]) * w["num_layers"]
    return dense + head + attn


def flash_call(w: dict, rows: int, seq: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOP, bytes) of one causal flash-attention call of a prefill: q, k
    and v read once, o written once."""
    h, kv, hd = w["num_heads"], w["num_kv_heads"], w["head_dim"]
    flops = causal_attention_flops(rows, seq, h, hd)
    nbytes = elem_bytes * rows * seq * hd * (2 * h + 2 * kv)
    return flops, nbytes


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least q % of
    the sample at or below it."""
    if not values:
        raise ValueError("percentile of an empty sample")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Sequence[Tuple[float, float]],
            spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the disjoint ``intervals`` that lies inside the disjoint
    ``spans``."""
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < e:
            total += max(0.0, min(e, intervals[k][1]) - max(s, intervals[k][0]))
            k += 1
    return total


def gaps(intervals: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end] between disjoint ``intervals``."""
    out, t = [], start
    for s, e in intervals:
        if e <= start or s >= end:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out
