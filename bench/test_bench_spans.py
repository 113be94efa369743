"""Device time by program span (``bench/spans.py``) on hand-written Chrome
events: operations tied to their launches by correlation id and by launch
order, nested spans, an operation launched outside every span and one with
no launch, idle gaps inside and outside the spans; the readers that take
shares from it; and the existing trace readers unchanged by what a card's
trace of the spanned program adds (correlation ids, program spans)."""
import random

import pytest

from bench import readers, spans, trace
from bench.harness import Run, Served, load_reader
from bench.test_bench_yardstick import GLM, _device_trace, _trace

P = spans.PREFIX


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(orphan=True):
    """One request in a window of 1,000 us. The host runs ahead of the
    device: each kernel starts well after its launch, under another span."""
    evs = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.request", 0, 500),
        _ev("cpu_op", P + "serve.prefill", 10, 390),
        _ev("cpu_op", P + "model.stack", 20, 280),
        _ev("cpu_op", P + "attention.core", 30, 70),
        _ev("cpu_op", P + "mlp", 120, 80),
        _ev("cpu_op", P + "model.head", 310, 80),
        _ev("cpu_op", "aten::mm", 36, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 35, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=2),
        _ev("cuda_driver", "cuLaunchKernelEx", 250, 5, corr=3),  # stack self time
        _ev("cuda_runtime", "cudaLaunchKernel", 320, 5, corr=4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 395, 3, corr=5),  # prefill self time
        _ev("cuda_runtime", "cudaStreamSynchronize", 400, 260, corr=6),
        _ev("kernel", "gemm_core", 100, 150, corr=1),
        _ev("kernel", "gemm_mlp", 250, 150, corr=2),
        _ev("kernel", "add", 400, 10, corr=3),
        _ev("kernel", "head", 600, 50, corr=4),
        _ev("gpu_memcpy", "Memcpy DtoH", 650, 5, corr=5),
    ]
    if orphan:  # a kernel whose launch the trace lacks
        evs.append(_ev("kernel", "orphan", 700, 20, corr=99))
    return evs


def _row(a, name):
    return next(r for r in a.table() if r["span"] == name)


def test_by_correlation_each_operation_goes_to_its_launching_span():
    a = spans.from_events(_events())
    assert a.window == pytest.approx((0.0, 1e-3))
    assert [o.span for o in a.ops] == [P + "attention.core", P + "mlp", P + "model.stack",
                                       P + "model.head", P + "serve.prefill", spans.NO_SPAN]
    want = {  # device us, kernels, idle us
        P + "attention.core": (150, 1, 100),  # the gap 0-100 has its middle in it
        P + "mlp": (150, 1, 0),
        P + "model.stack": (10, 1, 0),
        P + "model.head": (50, 1, 0),
        P + "serve.prefill": (5, 0, 0),  # a copy, not a kernel
        spans.NO_SPAN: (20, 1, 190 + 45 + 280),  # the orphan; gaps after the spans
    }
    assert {r["span"] for r in a.table()} == set(want)
    for name, (dev, n, idle) in want.items():
        r = _row(a, name)
        assert (r["device_s"], r["launches"], r["idle_s"]) == (
            pytest.approx(dev * 1e-6), n, pytest.approx(idle * 1e-6)), name
    assert a.busy_s() == pytest.approx(385e-6)
    assert a.busy_s() + sum(a.idle.values()) == pytest.approx(1e-3)
    assert a.busy_s(spans.CORE) == pytest.approx(150e-6)
    assert a.table()[0]["span"] in (P + "attention.core", P + "mlp")


def test_by_launch_order_agrees_where_every_operation_has_its_call():
    events = _events(orphan=False)
    by_corr = spans.from_events(events)
    by_order = spans.from_trace(trace.parse(events, n_requests=1))
    assert [(o.start, o.span) for o in by_order.ops] == [(o.start, o.span) for o in by_corr.ops]
    assert by_order.table() == by_corr.table()
    # a kernel without its launch call: the order is not to be trusted
    assert spans.from_trace(trace.parse(_events(), n_requests=1)) is None


def test_nothing_to_attribute_without_program_spans_or_device_operations():
    assert spans.from_trace(_trace()) is None and spans.from_trace(_device_trace()) is None
    no_spans = [e for e in _events() if not e["name"].startswith(P)]
    assert spans.from_events(no_spans) is None
    host_only = [e for e in _events() if e["cat"] not in trace.DEVICE_CATS]
    assert spans.from_events(host_only) is None


def _brute(spans_, t):
    held = [s for s in spans_ if s[0] <= t < s[1]]
    return max(held, key=lambda s: s[0])[2] if held else spans.NO_SPAN


def test_innermost_matches_a_brute_force_on_random_nestings():
    rng = random.Random(3)
    for _ in range(50):
        out, free = [], [(0.0, 100.0)]
        for i in range(rng.randint(0, 12)):  # nested: each inside a free slot
            lo, hi = free.pop(rng.randrange(len(free)))
            a, b = sorted(rng.uniform(lo, hi) for _ in range(2))
            out.append((a, b, f"s{i}"))
            free += [(lo, a), (a, b), (b, hi)]
        times = [rng.uniform(-5, 105) for _ in range(40)] + [None] + [s[0] for s in out]
        got = spans.innermost(out, times)
        assert got == [spans.NO_SPAN if t is None else _brute(out, t) for t in times]


def _run(host, device=None):
    cell = type("C", (), {"widths": GLM})()
    return Run(cell=cell, setup_s=1.0, window_end=1.0, served=[Served(0, 1, 4096, 0, 0.5)],
               trace=device, host_trace=host)


@pytest.mark.parametrize("metric,names", [
    ("attention_core_pct.latency", spans.CORE), ("attention_core_pct.throughput", spans.CORE),
    ("norm_rope_pct.latency", spans.NORM_ROPE), ("norm_rope_pct.throughput", spans.NORM_ROPE)])
def test_share_readers(metric, names):
    read = load_reader(metric)
    events = _events(orphan=False)
    if names == spans.NORM_ROPE:  # the core span's launch taken as a norm's
        events = [dict(e, name=P + "layer.norm") if e["name"] == P + "attention.core" else e
                  for e in events]
    host = trace.parse(events, n_requests=1)
    assert read(_run(host, _device_trace())) == pytest.approx(100 * 150 / 365)
    assert read(_run(_trace(), _device_trace())) is None  # a program without spans
    assert read(_run(None, None)) is None


def test_existing_readers_see_nothing_new_in_a_spanned_programs_trace(monkeypatch):
    """The fixtures of ``test_bench_yardstick``, with what the card's trace of
    the spanned program adds: correlation ids on every event, and program
    spans around the requests' host work."""
    made = []
    monkeypatch.setattr(trace, "parse", lambda evs, n_requests=0: made.append((evs, n_requests)))
    _trace()
    _device_trace()
    monkeypatch.undo()
    served = [Served(0, 1, 4096, 0.0, 0.4, "device"), Served(1, 1, 4096, 0.6, 1.0, "device")]
    for events, n in made:
        plain = trace.parse(events, n)
        marked = [dict(e, args={"correlation": i}) for i, e in enumerate(events)]
        spanned = marked + [_ev("cpu_op", P + "serve.prefill", 0, 390),
                            _ev("cpu_op", P + "model.stack", 600, 390)]
        for evs in (marked, spanned):
            t = trace.parse(evs, n)
            assert (t.window, t.device, t.n_requests) == (plain.window, plain.device, n)
            assert t.busy() == plain.busy() and t.top_ops() == plain.top_ops()
            assert t.kernels() == plain.kernels()
            gaps, want = dict(t.idle_gaps()), dict(plain.idle_gaps())
            assert sum(gaps.values()) == pytest.approx(sum(want.values()))
            if evs is marked:
                assert gaps == want
            for read in (readers.launches_per_request, readers.idle_pct):
                assert read(Run(None, 1.0, 1.0, served, trace=t)) == read(
                    Run(None, 1.0, 1.0, served, trace=plain))
            flash = load_reader("flash_attention_roofline")
            one = type("C", (), {"widths": dict(GLM, num_layers=1)})()
            assert flash(Run(one, 1.0, 1.0, served, trace=t)) == flash(
                Run(one, 1.0, 1.0, served, trace=plain))
