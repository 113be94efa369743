"""The benchmark's arithmetic against hand-worked numbers: FLOP and byte
counts, the percentile and its count, interval unions, the trace reading
and the readers that take metrics from it."""
import pytest

from bench import readers, trace, yardstick
from bench.harness import Run, Served

GLM = {"num_layers": 40, "d_model": 4096, "num_heads": 32, "num_kv_heads": 2,
       "head_dim": 128, "d_ff": 13696, "vocab_size": 151552}
NEMO = {"num_layers": 40, "d_model": 5120, "num_heads": 32, "num_kv_heads": 8,
        "head_dim": 128, "d_ff": 14336, "vocab_size": 131072}


def test_layer_matmul_params_by_hand():
    # glm4-9b: q 4096·4096, k and v 4096·256 each, o 4096·4096, MLP 3·4096·13696
    assert yardstick.layer_matmul_params(GLM) == (
        4096 * 4096 + 2 * 4096 * 256 + 4096 * 4096 + 3 * 4096 * 13696)
    # mistral-nemo-12b: q 5120·4096, k and v 5120·1024, o 4096·5120, MLP 3·5120·14336
    assert yardstick.layer_matmul_params(NEMO) == (
        5120 * 4096 + 2 * 5120 * 1024 + 4096 * 5120 + 3 * 5120 * 14336)


def test_parameter_totals_match_the_published_sizes():
    for w, billions in ((GLM, 9.4), (NEMO, 12.2)):
        total = (yardstick.layer_matmul_params(w) * w["num_layers"]
                 + 2 * w["d_model"] * w["vocab_size"])
        assert abs(total / 1e9 - billions) < 0.1


@pytest.mark.parametrize("w,rows,seq", [(GLM, 1, 4096), (NEMO, 8, 2048), (GLM, 32, 512)])
def test_prefill_flops_by_hand(w, rows, seq):
    tokens = rows * seq
    dense = 2 * tokens * yardstick.layer_matmul_params(w) * 40
    head = 2 * rows * w["d_model"] * w["vocab_size"]
    attn = 40 * 4 * rows * 32 * 128 * seq * seq / 2
    assert yardstick.prefill_flops(w, rows, seq) == pytest.approx(dense + head + attn, rel=1e-12)


def test_glm_prefill_of_a_mean_request():
    # 8.3e13 FLOP for a mean 4,640-token request, 7.0e12 of it attention
    assert yardstick.prefill_flops(GLM, 1, 4640) == pytest.approx(8.28e13, rel=0.01)
    attn = 40 * yardstick.causal_attention_flops(1, 4640, 32, 128)
    assert attn == pytest.approx(7.05e12, rel=0.01)


def test_flash_call_counts_and_bound():
    flops, nbytes = yardstick.flash_call(GLM, 2, 4096)
    assert flops == 4 * 2 * 32 * 128 * 4096 * 4096 / 2 == pytest.approx(2.749e11, rel=1e-3)
    # q and o: 2·4096·32·128 each; k and v: 2·4096·2·128 each; bf16
    assert nbytes == 2 * (2 * 2 * 4096 * 32 * 128 + 2 * 2 * 4096 * 2 * 128)
    assert yardstick.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)
    assert yardstick.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_percentile_nearest_rank_and_count_beyond():
    xs = list(range(1, 201))  # 200 samples
    assert yardstick.percentile(xs, 95) == 190
    assert sum(x > 190 for x in xs) == 10  # ten samples beyond it
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_union_covered_and_gaps():
    u = yardstick.union([(5, 7), (0, 2), (1, 3), (6, 6.5), (9, 9)])
    assert u == [(0, 3), (5, 7)]
    assert yardstick.covered(u, [(1, 6)]) == pytest.approx(3.0)
    assert yardstick.covered(u, [(-1, 0.5), (2.5, 5.5)]) == pytest.approx(1.5)
    assert yardstick.gaps(u, 0, 8) == [(3, 5), (7, 8)]
    assert yardstick.gaps(u, -1, 1) == [(-1, 0)]


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def _trace():
    """A window of 1,000 us with two requests and the host's operations;
    kernels overlap in the first, a flash kernel in each, the host busy
    between them."""
    return trace.parse([
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.request", 0, 400),
        _ev("user_annotation", "bench.request", 600, 400),
        _ev("cpu_op", "aten::mm", 0, 100),
        _ev("cpu_op", "aten::empty", 400, 200),
        _ev("kernel", "gemm", 10, 100),
        _ev("kernel", "fa_fwd_hopper", 50, 100),  # overlaps gemm
        _ev("gpu_memcpy", "Memcpy DtoH", 390, 5),
        _ev("kernel", "fa_fwd_hopper", 700, 200),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ], n_requests=2)


def _device_trace():
    """The same device activity recorded alone: no spans, the window
    between the two synchronisations, a kernel of the warm-up before it."""
    return trace.parse([
        _ev("kernel", "warm_up", -50, 20),
        _ev("cuda_runtime", "cudaDeviceSynchronize", -20, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 4),
        _ev("kernel", "gemm", 10, 100),
        _ev("kernel", "fa_fwd_hopper", 50, 100),
        _ev("gpu_memcpy", "Memcpy DtoH", 390, 5),
        _ev("cuda_runtime", "cudaStreamSynchronize", 380, 20),
        _ev("kernel", "fa_fwd_hopper", 700, 200),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 1000, 3),
    ], n_requests=2)


def test_trace_busy_union_and_breakdown():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy() == [pytest.approx((10e-6, 150e-6)), pytest.approx((390e-6, 395e-6)),
                        pytest.approx((700e-6, 900e-6))]
    assert t.busy_s() == pytest.approx(345e-6)
    ops = dict(t.top_ops())
    assert ops["fa_fwd_hopper"] == pytest.approx(300e-6)
    gaps = dict(t.idle_gaps())
    # 0-10 us is a short gap; 150-390 and 900-1000 lie in the requests'
    # spans alone; 395-700 has its middle in aten::empty
    assert gaps["gaps under 20 us"] == pytest.approx(10e-6)
    assert gaps["aten::empty"] == pytest.approx(305e-6)
    assert gaps["bench.request"] == pytest.approx(340e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 345e-6)


def test_device_only_trace_takes_its_window_from_the_synchronisations():
    t = _device_trace()
    assert t.window == pytest.approx((0.0, 1000e-6))
    assert t.busy_s() == pytest.approx(345e-6)  # the warm-up kernel lies outside
    assert len(t.kernels()) == 3 and len(t.kernels("fa_fwd")) == 2
    with pytest.raises(ValueError):
        trace.parse([_ev("kernel", "gemm", 0, 10),
                     _ev("cuda_runtime", "cudaDeviceSynchronize", 20, 1)])


def _run(t, served):
    cell = type("C", (), {"widths": GLM,
                          "flops": lambda self, r, s: yardstick.prefill_flops(GLM, r, s)})()
    return Run(cell=cell, setup_s=2.0, window_end=1.0, served=served, trace=t)


def _readers_agree(make):
    served = [Served(0, 1, 4096, 0.0, 0.4, "device"), Served(1, 1, 4096, 0.6, 1.0, "device")]
    r = _run(make(), served)
    assert readers.launches_per_request(r) == 1.5  # three kernels, two requests
    # a window of 1,000 us, of which 140 + 5 + 200 busy
    assert readers.idle_pct(r) == pytest.approx(100 * (1 - 345 / 1000))
    assert readers.prefill_mfu_pct(r) is None  # every request traced
    assert readers.prefill_mfu_pct(_run(None, [Served(0, 1, 4096, 0, 0.5)])) == (
        pytest.approx(100 * yardstick.prefill_flops(GLM, 1, 4096) / 0.5 / 989e12))
    assert readers.idle_pct(_run(None, served)) is None


def test_readers_on_the_trace():
    _readers_agree(_device_trace)


def test_readers_read_a_trace_with_host_operations_alike():
    _readers_agree(_trace)


def test_flash_roofline_reader_is_silent_when_the_launch_count_is_off():
    from bench.harness import load_reader

    read = load_reader("flash_attention_roofline")
    served = [Served(0, 1, 4096, 0.0, 0.4, "device")]
    assert read(_run(_trace(), served)) is None  # 2 launches, 40 layers expected
    one_layer = dict(GLM, num_layers=1)
    r = Run(cell=type("C", (), {"widths": one_layer})(), setup_s=1.0, window_end=1.0,
            served=served * 2 + [Served(2, 1, 4096, 1.0, 1.4, "host")], trace=_trace())
    bound = 2 * yardstick.bound_s(*yardstick.flash_call(one_layer, 1, 4096))
    assert read(r) == pytest.approx(100 * bound / 300e-6)
    assert read(_run(None, served)) is None


def test_ttft_and_rate_readers():
    from bench.harness import load_reader

    served = []
    for i in range(40):  # closed loop: each dispatched when the last one's token came
        start = served[-1].end if served else 0.0
        served.append(Served(i, 2, 100, start, start + 0.05 * (1 + i % 3)))
    r = _run(None, served)
    r.window_end = served[-1].end
    ttft = load_reader("ttft_p95_ms")(r)
    assert ttft == pytest.approx(150.0)
    assert load_reader("prompt_tok_per_s")(r) == pytest.approx(40 * 200 / served[-1].end)
    assert load_reader("setup_s")(r) == 2.0
