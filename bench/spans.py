"""Device time by program span: each device operation of a traced stretch
goes to the innermost ``repro_torch.*`` span (``src/repro_torch/spans.py``)
that was open on the host when the operation was launched, and each idle
gap to the innermost such span open at the gap's midpoint. An operation
launched outside every span, or whose launch the trace lacks, goes to
``NO_SPAN``.

An operation's launch is found in one of two ways:

- ``from_events``, from the profiler's Chrome events: the runtime or driver
  call with the operation's correlation id (``args.correlation``). Exact.
- ``from_trace``, from a ``bench.trace.Trace`` (which keeps no correlation
  ids): on one stream the device runs each kind of operation in the order
  the host asked for it, so the k-th kernel was launched by the k-th kernel
  launch call, and so for copies and fills. Gives nothing where a kind's
  operations and calls differ in number.

Times are the trace's, in seconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bench import trace as trace_mod
from bench import yardstick

PREFIX = "repro_torch."  # the program's, not imported: a program without spans reads None
NO_SPAN = "no span"
# the host call that asks for each kind of device operation, by a part of its name
CALLS = {"kernel": "LaunchKernel", "gpu_memcpy": "Memcpy", "gpu_memset": "Memset"}
CORE = (PREFIX + "attention.core",)
NORM_ROPE = (PREFIX + "layer.norm", PREFIX + "attention.rope")

Span = Tuple[float, float, str]


@dataclass
class Op:
    """A device operation and the span that launched it."""

    start: float
    end: float
    cat: str
    span: str


@dataclass
class Attribution:
    window: Tuple[float, float]
    ops: List[Op]
    idle: Dict[str, float]  # idle seconds in the window, by span

    def busy_s(self, names: Optional[Sequence[str]] = None) -> float:
        """Device busy time in the window, a union of intervals, of the
        operations launched under ``names`` (all where None)."""
        w0, w1 = self.window
        return sum(e - s for s, e in yardstick.union(
            (max(o.start, w0), min(o.end, w1)) for o in self.ops
            if (names is None or o.span in names) and o.end > w0 and o.start < w1))

    def table(self) -> List[dict]:
        """One row a span, the most device time first: device seconds (a
        union), kernels that started in the window, idle seconds."""
        w0, w1 = self.window
        names = {o.span for o in self.ops} | set(self.idle)
        rows = [{"span": n, "device_s": self.busy_s((n,)),
                 "launches": sum(o.cat == "kernel" and o.span == n and w0 <= o.start < w1
                                 for o in self.ops),
                 "idle_s": self.idle.get(n, 0.0)} for n in names]
        return sorted(rows, key=lambda r: (-r["device_s"], -r["idle_s"], r["span"]))


def innermost(spans: Iterable[Span], times: Sequence[Optional[float]]) -> List[str]:
    """The name of the innermost of ``spans`` (nested by containment) open
    at each of ``times``, or ``NO_SPAN``."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    out = [NO_SPAN] * len(times)
    stack: List[Span] = []
    j = 0
    for i in sorted((i for i, t in enumerate(times) if t is not None), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def attribute(window: Tuple[float, float], device: Sequence[Tuple[float, float, str]],
              launched: Sequence[Optional[float]], spans: Sequence[Span]) -> Attribution:
    """``device`` (start, end, cat) operations, each launched at the host
    time in ``launched`` (None: unknown), against the host's ``spans``."""
    names = innermost(spans, launched)
    ops = [Op(s, e, cat, n) for (s, e, cat), n in zip(device, names)]
    w0, w1 = window
    busy = yardstick.union((max(o.start, w0), min(o.end, w1)) for o in ops
                           if o.end > w0 and o.start < w1)
    gaps = yardstick.gaps(busy, w0, w1)
    idle: Dict[str, float] = {}
    for (s, e), n in zip(gaps, innermost(spans, [(s + e) / 2 for s, e in gaps])):
        idle[n] = idle.get(n, 0.0) + (e - s)
    return Attribution(window, ops, idle)


def _program_spans(host: Iterable[Span]) -> List[Span]:
    return [h for h in host if h[2].startswith(PREFIX)]


def from_trace(t) -> Optional[Attribution]:
    """The attribution of a parsed trace by launch order, or None where it
    holds no program span, no device operation, or a kind of operation
    whose count differs from its calls'."""
    spans = _program_spans(t.host)
    if not spans or not t.device:
        return None
    device = [(o.start, o.end, o.cat) for o in t.device]
    launched: List[Optional[float]] = [None] * len(device)
    for cat, call in CALLS.items():
        idx = [i for i, o in enumerate(t.device) if o.cat == cat]
        calls = sorted(s for s, _, name in t.host
                       if call in name and not name.startswith(PREFIX))
        if len(idx) != len(calls):
            return None
        for i, s in zip(idx, calls):
            launched[i] = s
    return attribute(t.window, device, launched, spans)


def from_events(events: list) -> Optional[Attribution]:
    """The attribution of Chrome-trace events (µs) by correlation id, in
    the window ``bench.trace.parse`` finds; None where they hold no program
    span or no device operation."""
    t = trace_mod.parse(events)
    launch: Dict[int, float] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, corr = ev.get("cat", ""), (ev.get("args") or {}).get("correlation")
        s = float(ev["ts"]) * 1e-6
        if cat in trace_mod.RUNTIME_CATS and corr is not None:
            launch[corr] = s
        elif cat in trace_mod.DEVICE_CATS:
            device.append((s, s + float(ev.get("dur", 0.0)) * 1e-6, cat, corr))
    spans = _program_spans(t.host)
    if not spans or not device:
        return None
    device.sort(key=lambda d: d[0])
    return attribute(t.window, [d[:3] for d in device], [launch.get(d[3]) for d in device],
                     spans)


def share_pct(run, names: Sequence[str]) -> Optional[float]:
    """The share of the traced requests' device busy time (a union of
    intervals) in operations launched under ``names``, from the stretch
    with the host's operations (the device-only stretch records no span),
    or None where it attributes nothing."""
    a = from_trace(run.host_trace) if run.host_trace is not None else None
    busy = a.busy_s() if a is not None else 0.0
    return 100.0 * a.busy_s(names) / busy if busy > 0 else None
