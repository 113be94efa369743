"""The one traffic generator: a mix file of parameters in, the sequence of
requests that the run's one client sends out.

A mix (``traffic/<name>.json``) says:
- ``lengths``: prompt lengths, log-uniform on [min, max] rounded to
  ``round``, and with ``cap`` no longer than the node's prompt limit;
- ``rows``: ``{"per_request": r}`` prompts a request, or
  ``{"token_budget": t}``: as many prompts of the request's one length as
  fit in t tokens;
- ``block``: the requests come in blocks of this many, each block the
  (k + ½)/block quantiles of the length distribution in an order drawn
  from the seed; so every seed sends the same lengths, any prefix of the
  run holds nearly the same mix, and ``--seed`` sets only the order and
  the token ids;
- ``order`` (optional): ``"fixed"`` sends every block in one order for
  every seed, the shortest, the longest, the next shortest, and so on
  inwards, so that a window that ends inside a block leaves out the same
  middle lengths whatever the seed, and ``--seed`` sets only the token
  ids; by default the order is drawn from the seed;
- ``sample``: the requests of the first block whose outputs the check
  compares, and the most rows of each;
- ``trace_requests``: how many of the window's first requests a traced
  run records with device activity only, and ``trace_host_requests`` how
  many after them it records with the host's operations too.

The loop is closed, with one client: a prefill node that dispatches the
next request as soon as the previous one's first token reached the host.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Tuple

POOL_TOKENS = 1 << 24  # prompt tokens a run prepares: many times a window's


@dataclass(frozen=True)
class Request:
    index: int
    rows: int
    seq: int

    @property
    def tokens(self) -> int:
        return self.rows * self.seq


def quantile_table(lengths: dict, n: int) -> List[int]:
    """n lengths at the (k + ½)/n quantiles of the mix's distribution."""
    if lengths.get("dist") != "log_uniform":
        raise ValueError(f"length distribution {lengths.get('dist')!r}: log_uniform")
    lo, hi, r = lengths["min"], lengths["max"], lengths["round"]
    cap = lengths.get("cap", hi)
    out = []
    for k in range(n):
        u = (k + 0.5) / n
        s = math.exp(math.log(lo) + u * math.log(hi / lo))
        out.append(min(cap, hi, max(lo, int(round(s / r)) * r)))
    return out


def rows_for(mix: dict, seq: int) -> int:
    rows = mix["rows"]
    if "per_request" in rows:
        return int(rows["per_request"])
    b = int(rows["token_budget"]) // seq
    if b < 1:
        raise ValueError(f"a token budget of {rows['token_budget']} holds no prompt of {seq}")
    return b


def sequence(mix: dict, seed: int) -> List[Request]:
    """The requests in the order the client sends them: whole blocks, as
    many as ``POOL_TOKENS`` holds, at least one."""
    rng = random.Random(seed)
    b = int(mix["block"])
    table = [(rows_for(mix, s), s) for s in quantile_table(mix["lengths"], b)]
    order = mix.get("order", "seed")
    if order == "fixed":
        table.sort(key=lambda rs: rs[1])
        table = [table[k // 2] if k % 2 == 0 else table[-1 - k // 2] for k in range(b)]
    elif order != "seed":
        raise ValueError(f"order {order!r}: seed or fixed")
    per_block = sum(r * s for r, s in table)
    out: List[Request] = []
    for _ in range(max(1, POOL_TOKENS // per_block)):
        blk = list(table)
        if order == "seed":
            rng.shuffle(blk)
        base = len(out)
        out.extend(Request(base + i, r, s) for i, (r, s) in enumerate(blk))
    return out


def sample(mix: dict, reqs: List[Request], seed: int) -> List[Tuple[int, List[int]]]:
    """(request index, rows) whose outputs the check compares, drawn from
    the seed: the longest request of the first block and others drawn from
    that block; of a request with more rows than ``sample.rows``, rows
    drawn with at least one from each half."""
    spec = mix["sample"]
    pool = reqs[:int(mix["block"])]
    rng = random.Random(seed ^ 0x5A4D)
    longest = max(pool, key=lambda r: (r.seq, -r.index))
    others = [r for r in pool if r.index != longest.index]
    picked = [longest] + rng.sample(others, min(len(others), int(spec["requests"]) - 1))
    out = []
    for r in picked:
        k = int(spec["rows"])
        if r.rows <= k:
            rows = list(range(r.rows))
        else:
            half = r.rows // 2
            rows = sorted({rng.randrange(half), rng.randrange(half, r.rows)}
                          | set(rng.sample(range(r.rows), k - 2)))
            while len(rows) < k:
                rows = sorted(set(rows) | {rng.randrange(r.rows)})
        out.append((r.index, rows))
    return out
