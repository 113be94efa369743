# Copied from src/repro/core/pushdown.py; the repro. imports are rewritten, and
# merge_row_streams merges on a torch device through the port's merge kernel.
"""Programmable pushdown operator plane — ship predicates, not blocks.

The engine's near-data handlers were a fixed table (``wal_append``, flush,
compaction, prep).  This module generalizes them into a small **verified
operator plane**: the initiator builds a filter / project / aggregate
program over key-value rows, the program travels as *plain data* (nested
tuples — never code, never closures), and the storage node evaluates it
against local SSTable extents under the ordinary read-lease +
``authorized_read`` fence.  Only matching rows (or aggregate state) cross
the fabric, so scan bytes-on-wire drop by the selectivity factor
(BPF-oF / Farview style pushdown, see PAPERS.md).

Safety model — both sides verify, nobody trusts the wire:

  * ``verify_program`` statically checks a program before it is submitted:
    structure, operator whitelist, expression depth / node budget, literal
    size, pickled size, and type consistency (bytes vs int operands).  The
    expression walk also rejects *shared or cyclic* sub-structure, which is
    what makes programs loop-free by construction: evaluation cost is
    linear in the (bounded) node count, so a malicious or buggy program
    cannot wedge a storage node.
  * ``stub_pushdown_scan`` re-runs the same verifier on the target before
    touching any block (defense in depth — a compromised or buggy
    initiator cannot ship an unverified program past its own API).

Correctness model — LSM shadowing makes naive remote filtering unsound: a
*newer non-matching* version on one source must still suppress an *older
matching* version on another.  The target therefore never silently drops
an in-range row; it returns three row kinds, each tagged with a globally
ordered precedence rank (lower = newer, assigned by the initiator's
planner):

  * matched   — passed the filter; carries the projected payload
  * suppressed — in range but failed the filter; **key + rank only**
  * tombstone — a delete marker; key + rank only

The initiator merges per-target streams (``ops.merge_runs`` on the
device), keeps the lowest rank per key, and only then drops
tombstone/suppressed winners — byte-identical to a local block-shipping
scan, which is exactly what the differential property test asserts.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Iterable, List, Optional, Sequence, Tuple

# NOTE: repro.core.lsm imports are deferred into the functions that need
# them — repro.core.lsm.__init__ imports db, and db imports this module.

# ------------------------------------------------------------- limits
MAX_DEPTH = 12  # expression nesting
MAX_NODES = 128  # expression tree size
MAX_LITERAL_BYTES = 1024  # any single bytes literal
MAX_PROGRAM_BYTES = 8192  # pickled program (what actually ships)

CMP_OPS = ("lt", "le", "gt", "ge", "eq", "ne")
BOOL_OPS = ("and", "or", "not")
STR_OPS = ("prefix", "contains")
AGGREGATES = ("count", "bytes", "min_key", "max_key")
PROJECTIONS = ("row", "key", "value")

_U32 = struct.Struct("<I")


class ProgramError(ValueError):
    """A pushdown program failed static verification."""


# ------------------------------------------------------------ builders
def key() -> tuple:
    return ("key",)


def value() -> tuple:
    return ("value",)


def lit(v) -> tuple:
    return ("lit", v)


def length(field: tuple) -> tuple:
    return ("len", field)


def cmp(op: str, a: tuple, b: tuple) -> tuple:
    return ("cmp", op, a, b)


def and_(*exprs: tuple) -> tuple:
    return ("and",) + exprs


def or_(*exprs: tuple) -> tuple:
    return ("or",) + exprs


def not_(expr: tuple) -> tuple:
    return ("not", expr)


def prefix(field: tuple, p: bytes) -> tuple:
    return ("prefix", field, ("lit", p))


def contains(field: tuple, p: bytes) -> tuple:
    return ("contains", field, ("lit", p))


def build_scan(lo: bytes = b"", hi: Optional[bytes] = None, *,
               where: Optional[tuple] = None,
               project: Optional[str] = None,
               aggregate: Optional[str] = None) -> dict:
    """Assemble + verify a scan program (the only public constructor)."""
    return verify_program({
        "v": 1, "lo": lo, "hi": hi,
        "filter": where, "project": project, "aggregate": aggregate,
    })


# ------------------------------------------------------------ verifier
def _type_of(node: Any, depth: int, budget: List[int], seen: set) -> str:
    """Walk one expression node; return its type ('bytes'|'int'|'bool').

    Raises ProgramError on anything outside the whitelist.  ``seen`` holds
    ids of visited composite nodes: revisiting one means the "tree" has
    shared or cyclic structure, which is rejected outright — acyclicity is
    what bounds evaluation, so it is enforced, not assumed.
    """
    if depth > MAX_DEPTH:
        raise ProgramError(f"expression deeper than {MAX_DEPTH}")
    budget[0] -= 1
    if budget[0] < 0:
        raise ProgramError(f"expression larger than {MAX_NODES} nodes")
    if not isinstance(node, tuple) or not node:
        raise ProgramError(f"expression node must be a non-empty tuple, "
                           f"got {type(node).__name__}")
    op = node[0]
    if op in ("len", "cmp", "and", "or", "not") or op in STR_OPS:
        # composite nodes must form a tree: re-visiting one means shared
        # or cyclic structure (leaves like ("key",) are interned constants
        # and may legitimately repeat)
        if id(node) in seen:
            raise ProgramError("cyclic or shared expression structure")
        seen.add(id(node))
    if op in ("key", "value"):
        if len(node) != 1:
            raise ProgramError(f"{op!r} node takes no operands")
        return "bytes"
    if op == "lit":
        if len(node) != 2:
            raise ProgramError("'lit' node takes exactly one operand")
        v = node[1]
        if isinstance(v, bool):
            raise ProgramError("bool literals are not allowed")
        if isinstance(v, bytes):
            if len(v) > MAX_LITERAL_BYTES:
                raise ProgramError(
                    f"bytes literal exceeds {MAX_LITERAL_BYTES} bytes")
            return "bytes"
        if isinstance(v, int):
            return "int"
        raise ProgramError(f"literal must be bytes or int, "
                           f"got {type(v).__name__}")
    if op == "len":
        if len(node) != 2:
            raise ProgramError("'len' node takes exactly one operand")
        if _type_of(node[1], depth + 1, budget, seen) != "bytes":
            raise ProgramError("'len' operand must be bytes-typed")
        return "int"
    if op == "cmp":
        if len(node) != 4:
            raise ProgramError("'cmp' node takes (op, lhs, rhs)")
        if node[1] not in CMP_OPS:
            raise ProgramError(f"unknown comparison {node[1]!r}")
        ta = _type_of(node[2], depth + 1, budget, seen)
        tb = _type_of(node[3], depth + 1, budget, seen)
        if ta == "bool" or tb == "bool":
            raise ProgramError("'cmp' operands must be bytes or int")
        if ta != tb:
            raise ProgramError(f"type confusion: comparing {ta} to {tb}")
        return "bool"
    if op in STR_OPS:
        if len(node) != 3:
            raise ProgramError(f"{op!r} node takes (field, literal)")
        if _type_of(node[1], depth + 1, budget, seen) != "bytes":
            raise ProgramError(f"{op!r} subject must be bytes-typed")
        if _type_of(node[2], depth + 1, budget, seen) != "bytes":
            raise ProgramError(f"{op!r} pattern must be bytes-typed")
        return "bool"
    if op in ("and", "or"):
        if len(node) < 3:
            raise ProgramError(f"{op!r} node takes at least two operands")
        for sub in node[1:]:
            if _type_of(sub, depth + 1, budget, seen) != "bool":
                raise ProgramError(f"{op!r} operands must be boolean")
        return "bool"
    if op == "not":
        if len(node) != 2:
            raise ProgramError("'not' node takes exactly one operand")
        if _type_of(node[1], depth + 1, budget, seen) != "bool":
            raise ProgramError("'not' operand must be boolean")
        return "bool"
    raise ProgramError(f"unknown operator {op!r}")


def verify_program(prog: Any) -> dict:
    """Statically verify a pushdown program; returns it, raises
    :class:`ProgramError` otherwise.  Run by the initiator at submit time
    AND independently by the engine before any block is read."""
    if not isinstance(prog, dict):
        raise ProgramError(f"program must be a dict, "
                           f"got {type(prog).__name__}")
    allowed = {"v", "lo", "hi", "filter", "project", "aggregate"}
    extra = set(prog) - allowed
    if extra:
        raise ProgramError(f"unknown program keys {sorted(extra)}")
    if prog.get("v") != 1:
        raise ProgramError(f"unsupported program version {prog.get('v')!r}")
    lo, hi = prog.get("lo"), prog.get("hi")
    if not isinstance(lo, bytes):
        raise ProgramError("'lo' must be bytes")
    if hi is not None and not isinstance(hi, bytes):
        raise ProgramError("'hi' must be bytes or None")
    if max(len(lo), 0 if hi is None else len(hi)) > MAX_LITERAL_BYTES:
        raise ProgramError(f"range bound exceeds {MAX_LITERAL_BYTES} bytes")
    proj = prog.get("project")
    if proj is not None and proj not in PROJECTIONS:
        raise ProgramError(f"unknown projection {proj!r}")
    agg = prog.get("aggregate")
    if agg is not None and agg not in AGGREGATES:
        raise ProgramError(f"unknown aggregate {agg!r}")
    if agg is not None and proj is not None:
        raise ProgramError("'aggregate' and 'project' are exclusive")
    flt = prog.get("filter")
    if flt is not None and _type_of(flt, 1, [MAX_NODES], set()) != "bool":
        raise ProgramError("filter must evaluate to a boolean")
    try:
        size = len(pickle.dumps(prog))
    except Exception as e:  # unpicklable payload smuggled into the tree
        raise ProgramError(f"program is not plain data: {e!r}") from e
    if size > MAX_PROGRAM_BYTES:
        raise ProgramError(
            f"program pickles to {size} bytes (max {MAX_PROGRAM_BYTES})")
    return prog


# ------------------------------------------------------------ evaluator
def _eval(node: tuple, k: bytes, v: bytes):
    op = node[0]
    if op == "key":
        return k
    if op == "value":
        return v
    if op == "lit":
        return node[1]
    if op == "len":
        return len(_eval(node[1], k, v))
    if op == "cmp":
        a, b = _eval(node[2], k, v), _eval(node[3], k, v)
        c = node[1]
        if c == "lt":
            return a < b
        if c == "le":
            return a <= b
        if c == "gt":
            return a > b
        if c == "ge":
            return a >= b
        if c == "eq":
            return a == b
        return a != b
    if op == "prefix":
        return _eval(node[1], k, v).startswith(_eval(node[2], k, v))
    if op == "contains":
        return _eval(node[2], k, v) in _eval(node[1], k, v)
    if op == "and":
        return all(_eval(s, k, v) for s in node[1:])
    if op == "or":
        return any(_eval(s, k, v) for s in node[1:])
    return not _eval(node[1], k, v)  # "not" — verifier admits nothing else


def eval_filter(prog: dict, k: bytes, v: bytes) -> bool:
    flt = prog.get("filter")
    return True if flt is None else bool(_eval(flt, k, v))


def project_row(prog: dict, k: bytes, v: bytes):
    proj = prog.get("project") or "row"
    if proj == "key":
        return k
    if proj == "value":
        return v
    return (k, v)


# ------------------------------------------------------------ aggregates
def agg_init(name: str):
    return 0 if name in ("count", "bytes") else None


def agg_add(name: str, state, k: bytes, vlen: int):
    """Fold one matched row in.  Aggregates are defined over (key, len)
    so the wire never needs value bytes for an aggregate-only scan."""
    if name == "count":
        return state + 1
    if name == "bytes":
        return state + len(k) + vlen
    if name == "min_key":
        return k if state is None or k < state else state
    return k if state is None or k > state else state  # max_key


def agg_merge(name: str, a, b):
    if name in ("count", "bytes"):
        return a + b
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b) if name == "min_key" else max(a, b)


# ----------------------------------------------------- wire row packing
# Suppressed/tombstone markers dominate a low-selectivity reply; packing
# them as one length-prefixed blob (4B len + key + 4B rank each) instead
# of a pickled tuple list keeps the marker tax to ~8 bytes over the key.
def pack_markers(markers: Sequence[Tuple[bytes, int]]) -> bytes:
    out = []
    for k, rank in markers:
        out.append(_U32.pack(len(k)))
        out.append(k)
        out.append(_U32.pack(rank))
    return b"".join(out)


def unpack_markers(blob: bytes) -> List[Tuple[bytes, int]]:
    out, off, n = [], 0, len(blob)
    while off < n:
        (klen,) = _U32.unpack_from(blob, off)
        off += 4
        k = blob[off:off + klen]
        off += klen
        (rank,) = _U32.unpack_from(blob, off)
        off += 4
        out.append((k, rank))
    return out


# ------------------------------------------------------------ engine stub
def _merge_ranked(sources: List[Tuple[int, Iterable[Tuple[bytes, bytes]]]]):
    """K-way merge of (rank, sorted-row-iterable) sources; duplicate keys
    resolve to the LOWEST rank (ranks are globally unique per source)."""
    import heapq

    heap, iters = [], []
    for rank, src in sources:
        it = iter(src)
        iters.append(it)
        for k, v in it:
            heap.append((k, rank, v, len(iters) - 1))
            break
    heapq.heapify(heap)
    last = None
    while heap:
        k, rank, v, i = heapq.heappop(heap)
        for k2, v2 in iters[i]:
            heapq.heappush(heap, ((k2, sources[i][0], v2, i)))
            break
        if k == last:
            continue
        last = k
        yield k, rank, v


def stub_pushdown_scan(io, tables: List[dict], prog: dict, *,
                       final: bool = False):
    """Engine-side evaluator.  ``tables`` is a list of
    ``{"runs", "size", "rank"}`` SSTables local to this target; rows flow
    from ``SSTableReader.range_items`` through the engine's pinned
    offload cache (``io.offload_read``), never raw off the device.

    Returns ``("agg", state, scanned)`` when ``final`` and the program
    aggregates (the planner only sets ``final`` when this sub-scan is
    provably the whole database range), else
    ``("rows", matched, marker_blob, scanned)`` where ``matched`` is
    ``[(key, rank, payload)]`` and ``marker_blob`` packs the
    suppressed/tombstone keys (see :func:`pack_markers`).
    """
    from repro_torch.core.lsm.compaction import _read_runs
    from repro_torch.core.lsm.memtable import TOMBSTONE
    from repro_torch.core.lsm.sstable import SSTableReader

    prog = verify_program(prog)  # defense in depth: drop unverified programs
    eng = getattr(io, "engine", None)
    lo, hi = prog["lo"], prog.get("hi")
    agg = prog.get("aggregate")
    key_only = prog.get("project") == "key"
    sources = []
    for t in tables:
        r = SSTableReader(_read_runs(io, t["runs"], t["size"]))
        sources.append((int(t["rank"]), r.range_items(lo, hi)))
    matched: List[tuple] = []
    markers: List[Tuple[bytes, int]] = []
    state = agg_init(agg) if agg else None
    scanned = 0
    for k, rank, v in _merge_ranked(sources):
        scanned += 1
        if v == TOMBSTONE or not eval_filter(prog, k, v):
            if not final:
                markers.append((k, rank))
            continue
        if final and agg:
            state = agg_add(agg, state, k, len(v))
        elif agg:
            matched.append((k, rank, len(v)))
        else:
            matched.append((k, rank, b"" if key_only else v))
    if eng is not None:
        eng.pushdown_scans += 1
        eng.pushdown_rows_in += scanned
        eng.pushdown_rows_out += len(matched)
    if final and agg:
        return ("agg", state, scanned)
    return ("rows", matched, pack_markers(markers), scanned)


# -------------------------------------------------- initiator-side merge
def _prefix32(k: bytes) -> int:
    """First 4 key bytes as a sortable int32 (big-endian, zero-padded).
    Clamped one below the bitonic kernel's sentinel; collisions are fine —
    equal prefixes form tie groups resolved by full key afterwards."""
    p = int.from_bytes(k[:4].ljust(4, b"\0"), "big")
    return min(p, 0xFFFFFFFE) - 0x80000000


def merge_row_streams(streams: List[List[tuple]],
                      device="cuda") -> List[tuple]:
    """Merge per-target row streams into one duplicate-free, key-sorted
    stream, lowest rank winning per key.  Each input is sorted by key with
    unique keys (targets dedupe internally).  The bulk ordering runs on
    ``device`` via one ``ops.merge_runs`` over 4-byte key prefixes (the
    merge kernel on a CUDA device); only the merged payload indices come
    back, and ties (equal prefixes) and rank resolution happen on the host.
    """
    streams = [s for s in streams if s]
    if not streams:
        return []
    if len(streams) == 1:
        return list(streams[0])
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    flat: List[tuple] = [r for s in streams for r in s]
    prefixes = np.array([_prefix32(r[0]) for r in flat], dtype=np.int32)
    idx = np.arange(len(flat), dtype=np.int32)
    cuts = np.cumsum([0] + [len(s) for s in streams])
    kv = torch.from_numpy(np.stack([prefixes, idx])).to(device)  # one copy
    _, mv = ops.merge_runs(kv[0], kv[1], cuts.tolist())
    mv = mv.cpu().numpy()
    mk = prefixes[mv]
    order = [flat[int(i)] for i in mv]
    rows: List[tuple] = []
    i, n = 0, len(order)
    while i < n:  # regroup prefix ties by (full key, rank)
        j = i + 1
        while j < n and mk[j] == mk[i]:
            j += 1
        if j - i > 1:
            rows.extend(sorted(order[i:j], key=lambda r: (r[0], r[1])))
        else:
            rows.append(order[i])
        i = j
    out: List[tuple] = []
    for r in rows:  # keys adjacent now: lowest rank wins
        if out and out[-1][0] == r[0]:
            if r[1] < out[-1][1]:
                out[-1] = r
        else:
            out.append(r)
    return out


def register_pushdown_stub(engine) -> None:
    """Attach the pushdown evaluator to an engine's stub table."""
    engine.register_stub("pushdown_scan", stub_pushdown_scan)
