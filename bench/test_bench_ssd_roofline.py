"""The SSD kernel's roofline reader (``metrics/ssd_roofline.py``): its
count of a call's work against the SSD term of the granite reference's own
FLOP count, and when it reads and when it stays silent."""
import importlib.util
import json
from pathlib import Path

import pytest

from bench import trace, yardstick
from bench.harness import Run, Served
from bench.reference import granite_hybrid

BENCH = Path(__file__).resolve().parent
GRANITE = json.loads((BENCH / "configs" / "granite-4.0-h-small.json").read_text())["widths"]
GLM = {"num_layers": 40, "d_model": 4096, "num_heads": 32, "num_kv_heads": 2,
       "head_dim": 128, "d_ff": 13696, "vocab_size": 151552}


def _metric():
    spec = importlib.util.spec_from_file_location("ssd_roofline_under_test",
                                                  BENCH / "metrics" / "ssd_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mixer_matrices(w) -> int:
    """Weights of one Mamba mixer's projections, from the port's own
    parameter spec (five in-projections and the out-projection)."""
    from repro_torch.models import ssm
    from repro_torch.models.config import get_config

    cfg = get_config("granite-4.0-h-small")
    assert (cfg.d_model, cfg.mamba.d_state) == (w["d_model"], w["mamba"]["d_state"])
    spec = ssm.mamba_spec(cfg)
    return sum(spec[k].shape[0] * spec[k].shape[1] for k in ("wz", "wx", "wB", "wC", "wdt", "wo"))


@pytest.mark.parametrize("rows,seq", [(1, 2304), (1, 7680), (2, 256), (1, 128)])
def test_flops_equal_the_ssd_term_of_prefill_flops(rows, seq):
    """One Mamba layer with no head, no experts and no conv taps: what
    ``prefill_flops`` counts beyond the mixer's projections is its SSD term."""
    one = dict(GRANITE, vocab_size=0, num_layers=1, block_pattern=["mamba"],
               moe=dict(GRANITE["moe"], num_experts=0, experts_per_token=0, shared_d_ff=0),
               mamba=dict(GRANITE["mamba"], d_conv=0))
    tokens = rows * seq
    ssd_term = granite_hybrid.prefill_flops(one, rows, seq) - 2 * tokens * _mixer_matrices(one)
    flops, nbytes = _metric().ssd_call(GRANITE, rows, seq)
    assert flops == ssd_term
    # x and y (128 heads of 64) and B and C (128) in bf16, dt and dt·A (128 heads) in f32,
    # the final state (128 x 128 x 64) in f32
    assert nbytes == tokens * (4 * 8192 + 4 * 128 + 8 * 128) + 4 * rows * 128 * 128 * 64


def test_granite_call_bound_by_bytes():
    flops, nbytes = _metric().ssd_call(GRANITE, 1, 7680)
    assert flops == pytest.approx(48.57e9, rel=1e-3)
    assert yardstick.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert nbytes == pytest.approx(0.2676e9, rel=1e-3)


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def _trace(kernels):
    """A device-only trace of a window from 0 to 1,000 us holding ``kernels``
    (name, start, duration in us)."""
    return trace.parse([_ev("cuda_runtime", "cudaDeviceSynchronize", -20, 20)]
                       + [_ev("kernel", n, s, d) for n, s, d in kernels]
                       + [_ev("cuda_runtime", "cudaDeviceSynchronize", 1000, 3)], n_requests=1)


SSD = ["void repro_ssd::(anonymous namespace)::cb_kernel<128>(...)",
       "void repro_ssd::(anonymous namespace)::state_kernel<128>(...)",
       "void repro_ssd::(anonymous namespace)::pass_kernel<128>(...)",
       "void repro_ssd::(anonymous namespace)::scan_kernel<128, 8>(...)"]


def _run(widths, t):
    cell = type("C", (), {"widths": widths})()
    served = [Served(0, 1, 2304, 0.0, 0.9, "device"), Served(1, 1, 2304, 1.0, 1.9, "host")]
    return Run(cell=cell, setup_s=1.0, window_end=2.0, served=served, trace=t)


def test_reads_the_launches_of_every_mamba_layer():
    w = dict(GRANITE, num_layers=2, block_pattern=["mamba", "attn"])  # one Mamba layer
    t = _trace([("gemm", 0, 50)] + [(n, 100 + 100 * i, 40) for i, n in enumerate(SSD)])
    metric = _metric()
    bound = yardstick.bound_s(*metric.ssd_call(w, 1, 2304))
    assert metric.read(_run(w, t)) == pytest.approx(100 * bound / 160e-6)


def test_silent_without_the_kernel_or_with_another_count():
    read = _metric().read
    w = dict(GRANITE, num_layers=2, block_pattern=["mamba", "attn"])
    # the scan in plain PyTorch (the parent): no SSD kernel at all
    assert read(_run(w, _trace([("gemm", 0, 50), ("elementwise_kernel", 60, 10)]))) is None
    # three launches where one Mamba layer makes four
    assert read(_run(w, _trace([(n, 100 + 100 * i, 40) for i, n in enumerate(SSD[:3])]))) is None
    # 36 Mamba layers expected, one layer's launches found
    assert read(_run(GRANITE, _trace([(n, 100 + 100 * i, 40)
                                      for i, n in enumerate(SSD)]))) is None
    # a dense cell, and a run without a trace
    assert read(_run(GLM, _trace([("gemm", 0, 50)]))) is None
    assert read(_run(w, None)) is None
    assert _metric().mamba_layers(GRANITE) == 36
