"""What the metric readers under ``metrics/`` share. Each reader takes the
run (``harness.Run``) and returns a number, or None where the run gave it
nothing to read; the harness then leaves the metric out of the line."""
from __future__ import annotations

from typing import List, Optional

from bench import yardstick


def ttft_ms(run) -> List[float]:
    """Every served request's time from its dispatch to its first token on
    the host, ms."""
    return [(s.end - s.start) * 1e3 for s in run.served]


def prefill_mfu_pct(run) -> Optional[float]:
    """The benchmark's FLOP count of the prefills served outside the traced
    stretches over their summed time (dispatch to token on the host), as a
    share of the bf16 peak."""
    done = [s for s in run.served if not s.traced]
    busy = sum(s.end - s.start for s in done)
    if not done or busy <= 0:
        return None
    flops = sum(run.flops(s.rows, s.seq) for s in done)
    return 100.0 * flops / busy / yardstick.PEAK_BF16_FLOPS


def launches_per_request(run) -> Optional[float]:
    """Kernels launched a request (its prefill and its first token) in the
    device-only trace."""
    t = run.trace
    if t is None or not t.n_requests:
        return None
    n = len(t.kernels())
    return n / t.n_requests if n else None


def idle_pct(run) -> Optional[float]:
    """Share of the device-only trace's window in which no device operation
    ran, from a union of intervals. The client is a closed loop, so the
    window is the requests' service back to back."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    busy = t.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)
