"""granite-4.0-h-small's plain reference (``bench/reference/granite_hybrid.py``)
on its own, on the CPU: its SSM's quadratic form against the recurrence
step by step, its blocks changing no answer, its float8 control departing,
its weight scales, and its count of a prefill's work at the published
widths."""
import json
from pathlib import Path

import pytest
import torch

from bench.reference import granite_hybrid as ref
from bench.reference.dense_gqa import Precision

CONFIG = Path(__file__).resolve().parent / "configs" / "granite-4.0-h-small.json"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ssm_inputs(R=2, S=300, H=6, P=8, N=5, seed=0):
    """Inputs as the mixer makes them: dt > 0, A < 0 over two decades, so
    that some heads forget within a few tokens and some remember the whole
    prompt."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((R, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((R, S, H), generator=g))
    A = -torch.logspace(-2, 0.5, H)
    Bm, Cm = (torch.randn((R, S, N), generator=g) for _ in range(2))
    D = torch.randn((H,), generator=g)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("q_block,h_block", [(300, 6), (64, 4), (7, 1)])
def test_quadratic_form_and_state_equal_the_recurrence(q_block, h_block):
    x, dt, A, Bm, Cm, D = ssm_inputs()
    y_rec, h_rec = ref.ssm_recurrence(x.double(), dt.double(), A.double(), Bm.double(),
                                      Cm.double(), D.double())
    y = ref._ssm_quadratic(x, dt, A, Bm, Cm, D, Precision("f32"), q_block, h_block)
    torch.testing.assert_close(y.double(), y_rec, rtol=1e-5, atol=1e-5 * y_rec.abs().max())
    h = ref._ssm_state(x, dt, A, Bm)
    torch.testing.assert_close(h.double(), h_rec, rtol=1e-5, atol=1e-5 * h_rec.abs().max())


def test_a_long_prompt_keeps_the_decay_exact():
    """S 4,096 with a head whose decays sum past -2,000 over the prompt:
    the decays between nearby positions, differences of those sums, stay
    exact (the sums are float64)."""
    x, dt, A, Bm, Cm, D = ssm_inputs(R=1, S=4096, H=2, P=4, N=3, seed=1)
    A = torch.tensor([-1.0, -0.002])
    y_rec, _ = ref.ssm_recurrence(x.double(), dt.double(), A.double(), Bm.double(),
                                  Cm.double(), D.double())
    y = ref._ssm_quadratic(x, dt, A, Bm, Cm, D, Precision("f32"), 1024, 2)
    assert (dt * -A).sum(1).max() > 2000
    torch.testing.assert_close(y.double(), y_rec, rtol=1e-5, atol=1e-5 * y_rec.abs().max())


def test_fp8_control_departs_from_f32():
    x, dt, A, Bm, Cm, D = ssm_inputs()
    f32 = ref._ssm_quadratic(x, dt, A, Bm, Cm, D, Precision("f32"), 128, 3)
    fp8 = ref._ssm_quadratic(x, dt, A, Bm, Cm, D, Precision("fp8"), 128, 3)
    rel = (fp8 - f32).norm() / f32.norm()
    assert 0.005 < rel < 0.3


def test_fan_in_draws_what_the_check_must_see():
    """Unit scale for the Mamba mixer's per-head and per-channel leaves, the
    taps for the conv, the input width for a routed expert, d for the tied
    embedding; the rest as the benchmark's default."""
    d, E, f = 4096, 72, 768
    assert ref.fan_in(("stack", "scan", 0, "mamba", "gnorm"), (4, 8192), True) == 1
    for leaf in ("A_log", "dt_bias", "Dskip", "conv_b"):
        assert ref.fan_in(("stack", "unroll", 0, "mamba", leaf), (128,), False) == 1
    assert ref.fan_in(("stack", "scan", 0, "mamba", "conv"), (4, 4, 8448), True) == 4
    assert ref.fan_in(("stack", "scan", 0, "moe", "wi"), (4, E, d, f), True) == d
    assert ref.fan_in(("stack", "scan", 0, "moe", "wo"), (4, E, f, d), True) == f
    assert ref.fan_in(("stack", "scan", 0, "moe", "shared", "wo"), (4, 1536, d), True) == 1536
    assert ref.fan_in(("stack", "scan", 0, "moe", "router"), (4, d, E), True) == d
    assert ref.fan_in(("stack", "scan", 5, "attn", "wo"), (4, 8, 4, 128, d), True) == 4096
    assert ref.fan_in(("embed",), (100352, d), False) == d


def test_prefill_flops_at_the_published_widths():
    """132.6 TFLOP for a 7,680-token prompt (134 ms at the bf16 peak), of
    which the 4 attention layers' causal products are 1.5 %."""
    w = json.loads(CONFIG.read_text())["widths"]
    total = ref.prefill_flops(w, 1, 7680)
    assert total == pytest.approx(132.57e12, rel=1e-3)
    mamba_w = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    moe_w = 4096 * 72 + 3 * 4096 * 768 * 10 + 3 * 4096 * 1536
    assert (mamba_w, moe_w) == (102_236_160, 113_541_120)
    attn = 4 * 4.0 * 32 * 128 * 7680 ** 2 / 2
    assert 0.014 < attn / total < 0.015
    assert ref.prefill_flops(w, 2, 7680) == pytest.approx(2 * total, rel=1e-9)


def test_num_layers_counts_the_attention_layers_of_the_stack():
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    w = json.loads(CONFIG.read_text())["widths"]
    for scan in (True, False):
        cfg = get_config("granite-4.0-h-small").with_(**w, scan_layers=scan)
        assert ref.num_layers(build_model(cfg).abstract_params()) == 4
