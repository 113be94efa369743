"""The RMSNorm kernel's share of its roofline, which
``metrics/rms_norm_roofline.latency.py`` and ``.throughput.py`` read: Σ bound
over Σ device time of its launches (kernels under ``repro_rmsnorm::``) in
the device-only traced requests.

A prefill of L layers runs 2·L + 1 norms: ln1 and ln2 of every layer over
its rows · seq tokens, and the final norm over the last position of each
row. The bound of a call over n rows of width d is its bytes at HBM's
bandwidth, (n·d·(2 + 2) + 2·d) / 3.35 TB/s: x read and y written in bf16,
the bf16 scale read once; its four operations an element are nothing
beside them. Silent where the traced prefills launched no such kernel
(where the program runs the norm in plain PyTorch), more than 2·L + 1 a
prefill, or fewer than MIN_FOUND of them. The profiler may lose a few
kernel records of a long trace (34 of 29,970 in one granite trace on an
H100, 0 in the next run of the same seed); the bound then counts the
share of the calls whose launches it holds.
"""
from bench import yardstick

KERNEL = "repro_rmsnorm::"
MIN_FOUND = 0.95  # of the expected launches, for a reading


def norm_bytes(d: int, n: int) -> int:
    """Bytes one norm over ``n`` rows of width ``d`` must move."""
    return n * d * (2 + 2) + 2 * d


def norms_per_prefill(w: dict) -> int:
    return 2 * w["num_layers"] + 1


def prefill_bound_s(w: dict, rows: int, seq: int) -> float:
    """The least time the norms of one prefill of ``rows`` prompts of
    ``seq`` tokens could take at the widths ``w``."""
    d, layers = w["d_model"], w["num_layers"]
    nbytes = 2 * layers * norm_bytes(d, rows * seq) + norm_bytes(d, rows)
    return nbytes / yardstick.PEAK_HBM_BYTES


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = t.kernels(KERNEL)
    traced = [s for s in run.served if s.traced == "device"]
    if not calls or not traced:
        return None
    found = len(calls) / (norms_per_prefill(run.widths) * len(traced))
    if not MIN_FOUND <= found <= 1:
        return None
    bound = sum(prefill_bound_s(run.widths, s.rows, s.seq) for s in traced)
    took = sum(o.end - o.start for o in calls)
    return 100.0 * found * bound / took
