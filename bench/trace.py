"""The trace of a stretch of a run's requests, read from the profiler's
Chrome trace: device operations, host operations where the profiler
recorded them, and the stretch's window.

The window is the benchmark's span ``bench.window`` where the trace holds
the host's operations. A trace of device activity alone holds no spans; its
window runs from the end of the first ``cudaDeviceSynchronize`` to the
start of the last, the two that the harness calls around the stretch.

All times here are the trace's, in seconds.
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from bench import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "DeviceSynchronize"
SHORT_GAP_S = 20e-6


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float
    end: float


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[DeviceOp]
    host: List[Tuple[float, float, str]] = field(default_factory=list)
    n_requests: int = 0  # requests served inside the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """Disjoint intervals in which some device operation ran, inside
        the window."""
        w0, w1 = self.window
        return yardstick.union((max(o.start, w0), min(o.end, w1)) for o in self.device
                               if o.end > w0 and o.start < w1)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernels(self, substring: str = "") -> List[DeviceOp]:
        """Kernels that started inside the window, by a part of their name."""
        w0, w1 = self.window
        return [o for o in self.device
                if o.cat == "kernel" and substring in o.name and w0 <= o.start < w1]

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for o in self.device:
            tot[o.name[:96]] += o.end - o.start
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time inside the window, summed by the innermost host
        operation running at each gap's midpoint; gaps under 20 us as one."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        tot: Dict[str, float] = defaultdict(float)
        for s, e in yardstick.gaps(self.busy(), *self.window):
            if e - s < SHORT_GAP_S:
                tot["gaps under 20 us"] += e - s
                continue
            tot[_doing(host, starts, (s + e) / 2)] += e - s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _doing(host, starts, t: float, look: int = 20000) -> str:
    i = bisect_right(starts, t) - 1
    stop = max(-1, i - look)
    while i > stop:
        s, e, name = host[i]
        if e > t:
            return name
        i -= 1
    return "no host operation"


def parse(events: list, n_requests: int = 0) -> Trace:
    """A Trace from Chrome-trace events (µs)."""
    device, host, window, markers = [], [], None, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append(DeviceOp(name, cat, s, e))
        elif cat == "user_annotation" and name == "bench.window":
            window = (s, e)
        elif cat in ("cpu_op", "user_annotation") + RUNTIME_CATS:
            host.append((s, e, name))
            if cat in RUNTIME_CATS and MARKER in name:
                markers.append((s, e))
    if window is None:
        if len(markers) < 2:
            raise ValueError("the trace has neither a bench.window span nor two "
                             f"{MARKER} markers")
        markers.sort()
        window = (markers[0][1], markers[-1][0])
    device.sort(key=lambda o: o.start)
    return Trace(window, device, host, n_requests)


def export(prof) -> str:
    """Write ``prof`` (a ``torch.profiler.profile`` just stopped) to a file
    in the temporary directory and return its path. It has to be written
    before the next profiler starts: a trace exported after another
    session reads every time as 0."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def load(path: str, n_requests: int = 0) -> Trace:
    """Parse an exported trace and delete its file."""
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return parse(events, n_requests)
