"""The RMSNorm kernel's roofline readers (``metrics/rms_norm_roofline.*``,
both ``rms_norm_kernel.read``): the bound of a prefill's norms at one shape
counted by hand, and when they read and when they stay silent."""
import importlib.util
import json
from pathlib import Path

import pytest

from bench import rms_norm_kernel, trace
from bench.harness import Run, Served

BENCH = Path(__file__).resolve().parent
GLM = json.loads((BENCH / "configs" / "glm4-9b.json").read_text())["widths"]
NEMO = json.loads((BENCH / "configs" / "mistral-nemo-12b.json").read_text())["widths"]
GRANITE = json.loads((BENCH / "configs" / "granite-4.0-h-small.json").read_text())["widths"]


def _metric(kind):
    path = BENCH / "metrics" / f"rms_norm_roofline.{kind}.py"
    spec = importlib.util.spec_from_file_location(f"rms_norm_roofline_{kind}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_glm4_long_prefill_bound_by_hand():
    """glm4-9b, one prompt of 7,680 tokens: 80 norms over 7,680 rows of
    4,096 (x in and y out in bf16, the scale once) and the head's over one
    row, at 3.35 TB/s."""
    layer_norm = 7680 * 4096 * 4 + 4096 * 2  # 125,837,312 bytes
    head_norm = 4096 * 4 + 4096 * 2  # 24,576
    assert rms_norm_kernel.norm_bytes(4096, 7680) == layer_norm == 125_837_312
    assert rms_norm_kernel.norms_per_prefill(GLM) == 81
    want = (80 * 125_837_312 + 24_576) / 3.35e12  # 3.00508 ms
    assert rms_norm_kernel.prefill_bound_s(GLM, 1, 7680) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(3.00508e-3, rel=1e-5)


def test_short_batch_counts_the_head_at_each_row():
    """mistral-nemo-12b, a batch of 8 prompts of 2,048: the layers' norms
    over 16,384 rows of 5,120, the head's over 8 rows."""
    want = (80 * (16384 * 5120 * 4 + 5120 * 2) + (8 * 5120 * 4 + 5120 * 2)) / 3.35e12
    assert rms_norm_kernel.prefill_bound_s(NEMO, 8, 2048) == pytest.approx(want, rel=1e-12)


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


NORM = "void repro_rmsnorm::(anonymous namespace)::rms_norm_kernel<8, __nv_bfloat16>(...)"


def _trace(kernels, n_requests=1):
    """A device-only trace of a window from 0 to 10,000 us holding
    ``kernels`` (name, start, duration in us)."""
    return trace.parse([_ev("cuda_runtime", "cudaDeviceSynchronize", -20, 20)]
                       + [_ev("kernel", n, s, d) for n, s, d in kernels]
                       + [_ev("cuda_runtime", "cudaDeviceSynchronize", 10000, 3)],
                       n_requests=n_requests)


def _run(widths, t, device_requests=1, rows=1, seq=2304):
    cell = type("C", (), {"widths": widths})()
    served = [Served(i, rows, seq, float(i), i + 0.9, "device") for i in range(device_requests)]
    served.append(Served(device_requests, rows, seq, 9.0, 9.9, "host"))
    return Run(cell=cell, setup_s=1.0, window_end=10.0, served=served, trace=t)


TWO_LAYERS = dict(GLM, num_layers=2)  # five norms a prefill


@pytest.mark.parametrize("kind", ["latency", "throughput"])
def test_reads_every_norm_of_the_device_requests(kind):
    norms = [(NORM, 100 + 100 * i, 20) for i in range(10)]  # two requests of 5
    t = _trace([("gemm", 0, 50)] + norms, n_requests=2)
    bound = 2 * rms_norm_kernel.prefill_bound_s(TWO_LAYERS, 1, 2304)
    got = _metric(kind)(_run(TWO_LAYERS, t, device_requests=2))
    assert got == pytest.approx(100 * bound / 200e-6)


def test_a_few_lost_launches_scale_the_bound():
    """Six full-depth prefills (486 launches) with 5 records lost: the bound
    of the calls found; 25 lost (more than 5 %) reads nothing."""
    norms = [(NORM, 10 + 2 * i, 1) for i in range(486)]
    bound = 6 * rms_norm_kernel.prefill_bound_s(GRANITE, 1, 2304)
    read = _metric("latency")
    got = read(_run(GRANITE, _trace(norms[5:], n_requests=6), device_requests=6))
    assert got == pytest.approx(100 * (481 / 486) * bound / 481e-6)
    assert read(_run(GRANITE, _trace(norms[25:], n_requests=6), device_requests=6)) is None


@pytest.mark.parametrize("kind", ["latency", "throughput"])
def test_silent_without_the_kernel_or_with_another_count(kind):
    read = _metric(kind)
    five = [(NORM, 100 + 100 * i, 20) for i in range(5)]
    # the norm in plain PyTorch (the parent): no repro_rmsnorm kernel at all
    assert read(_run(TWO_LAYERS, _trace([("gemm", 0, 50), ("elementwise_kernel", 60, 10)]))) \
        is None
    # four launches where a two-layer prefill makes five (80 %), and six
    assert read(_run(TWO_LAYERS, _trace(five[:4]))) is None
    assert read(_run(TWO_LAYERS, _trace(five + [(NORM, 900, 20)]))) is None
    # 81 expected at full depth, five found
    assert read(_run(GRANITE, _trace(five))) is None
    # a run without a trace, and one whose traced requests were all host-traced
    assert read(_run(TWO_LAYERS, None)) is None
    assert read(_run(TWO_LAYERS, _trace(five), device_requests=0)) is None
    assert read(_run(TWO_LAYERS, _trace(five))) is not None
