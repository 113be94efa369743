"""granite-4.0-h-small's plain reference (``bench/reference/granite_hybrid.py``)
against the program at small sizes on the CPU: the benchmark's weights
from a seed (with the reference's own ``fan_in``), the program in float32,
in the unrolled and the stacked layouts and at one and two chunks of the
scan:

- the last position's logits, and each attention layer's cached k and v;
- each Mamba layer's final conv inputs and SSM state in the program's
  cache, against the reference's closed form of the recurrence;
- a prefill and then 4 decode steps through the program's cache, against
  the reference's full forward over the longer prompt;
- a whole run of the cell at small widths: correct, and not correct when
  the cache is left unwritten or the served token altered; and on one
  prompt at a wider size, against the cell's limits, not correct with the
  norm weights left out or the float8 control in the program's place.

Tolerances 2e-5 of the largest magnitude, as ``test_bench_reference.py``:
float32 summation order over ten layers.
"""
import copy

import pytest
import torch

from bench import harness, traffic, weights
from bench.reference import granite_hybrid as ref

CELL = "granite-4.0-h-small.long_prompt"
SEED = 2**31 + 77
TOL = 2e-5
SMALL = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "vocab_size": 256,
         "moe": {"num_experts": 8, "experts_per_token": 2, "expert_d_ff": 32, "dropless": True,
                 "shared_d_ff": 48},
         "mamba": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16, "chunk": 256,
                   "conv_bias": True}}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Small CPU runs on one intra-op thread, so that a parallel test run
    keeps its cores for the other workers; and a pool of prompts that a
    small window needs, not the card's."""
    monkeypatch.setattr(traffic, "POOL_TOKENS", 1 << 17)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_widths(num_layers=10):
    w = copy.deepcopy(harness.load_cell(CELL).widths)
    w.update(copy.deepcopy(SMALL), num_layers=num_layers)
    return w


def program(scan: bool):
    """The cell's program at small widths in f32: one period of ten layers
    unrolled, or two stacked."""
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    w = small_widths(20 if scan else 10)
    cfg = get_config("granite-4.0-h-small").with_(
        **w, scan_layers=scan, param_dtype=torch.float32, compute_dtype=torch.float32)
    model = build_model(cfg)
    params = weights.make(model.abstract_params(), SEED, "cpu", torch.float32,
                          fan_in=ref.fan_in)
    return w, model, params


def tokens(rows, seq, seed=5):
    return torch.randint(0, 256, (rows, seq), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def close(got, want):
    assert got.shape == want.shape
    assert (got.float() - want).abs().max() <= TOL * want.abs().max()


def mamba_states(cache):
    """[(conv, ssm)] of each Mamba layer in order, from either layout."""
    stack = cache["stack"]
    if "scan" in stack:
        period = stack["scan"]
        n = next(lc["ssm"].shape[0] for lc in period if "ssm" in lc)
        return [(lc["conv"][j], lc["ssm"][j]) for j in range(n) for lc in period if "ssm" in lc]
    return [(lc["conv"], lc["ssm"]) for lc in stack["unroll"] if "ssm" in lc]


LAYOUTS = [(False, 256), (True, 256), (False, 512), (True, 512)]
IDS = ["unroll-s256", "scan-s256", "unroll-s512", "scan-s512"]


@pytest.mark.parametrize("scan,seq", LAYOUTS, ids=IDS)
def test_reference_matches_the_program_in_f32(scan, seq):
    w, model, params = program(scan)
    toks = tokens(2, seq)
    kv, states = [], []
    with torch.inference_mode():
        logits, cache = harness.program_step(model, seq)(params, {"tokens": toks})
        want = ref.prefill(params, w, toks, attn_block=96, ssm_block=160, head_block=3,
                           on_kv=lambda i, k, v: kv.append((k, v)),
                           on_state=lambda i, c, s: states.append((c, s)))
    close(logits[:, -1], want)
    got_kv = harness.program_kv(cache)
    assert len(got_kv) == len(kv) == ref.num_layers(params) == w["num_layers"] // 10
    for (pk, pv), (rk, rv) in zip(got_kv, kv):
        close(pk, rk)
        close(pv, rv)
    got_states = mamba_states(cache)
    assert len(got_states) == len(states) == 9 * w["num_layers"] // 10
    for (pc, ps), (rc, rs) in zip(got_states, states):
        close(pc, rc)
        close(ps, rs)


@pytest.mark.parametrize("scan,seq", LAYOUTS, ids=IDS)
def test_prefill_then_4_decode_steps_match_the_full_forward(scan, seq):
    from repro_torch.serve.step import make_decode_step

    w, model, params = program(scan)
    full = tokens(2, seq + 4, seed=seq)
    step = make_decode_step(model)
    with torch.inference_mode():
        logits, cache = harness.program_step(model, seq + 4)(params,
                                                              {"tokens": full[:, :seq]})
        got = [logits[:, 0]]
        for t in range(4):
            _, logits, cache = step(params, cache, full[:, seq + t:seq + t + 1])
            got.append(logits[:, 0])
        h = ref.prefill(params, w, full, all_positions=True, ssm_block=200, head_block=8)
        want = ref.logits(params, h[:, seq - 1:], scaling=w["logits_scaling"])
    for t in range(5):
        close(got[t], want[:, t])


# ---------------------------------------------------------- a whole run
def small_cell(**widths):
    """The cell at small widths with prompts of 512 to 1,024 tokens (2 to 4
    chunks of the scan): a window of a few seconds on the CPU."""
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["widths"].update(small_widths(), **widths)
    cell.mix = copy.deepcopy(cell.mix)
    cell.mix["lengths"].update(min=512, max=1024, round=256)
    cell.mix.update(block=2, sample={"requests": 2, "rows": 1})
    return cell


def run(cell=None):
    return harness.run(cell or small_cell(), SEED, 3.0, False, device="cpu")


def _state_zeroed(step):
    def broken(params, batch):
        logits, cache = step(params, batch)
        for k, v in harness.program_kv(cache):
            k.zero_()
            v.zero_()
        return logits, cache
    return broken


FAULTS = {
    "state_unchanged": ("program_step", lambda orig: lambda m, s: _state_zeroed(orig(m, s))),
    "token_altered": ("first_token", lambda orig: lambda logits: (orig(logits) + 1) % 256),
}


def test_sound_run_is_correct():
    res = run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"ttft_p95_ms", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(harness, attr, wrap(getattr(harness, attr)))
    res = run()
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_norms_dropped_and_the_float8_control_are_not_correct():
    """One prompt at a size where float8's error shows as on the card (20
    layers at d 256: the control's kv_err 0.17-0.18 here, 0.27-0.29 on the
    card; the program's 0.06 both), judged against the cell's own limits:
    the program's prefill is correct; the same prefill with every norm
    weight left out is not, nor is the reference computed in float8 in the
    program's place."""
    cell = small_cell(num_layers=20, d_model=256, num_heads=16)
    model = harness.build_program(cell, torch.device("cpu"))
    params = harness.make_params(cell, model, SEED, "cpu")
    toks = tokens(1, 512)
    outs = []
    with torch.inference_mode():
        for p in (params, weights.with_unit_scales(params)):
            logits, cache = harness.program_step(model, 512)(p, {"tokens": toks})
            outs.append(harness.Output([0], toks, logits, harness.first_token(logits),
                                       harness.program_kv(cache)))
        kv = []
        fp8 = ref.prefill(params, cell.widths, toks, precision="fp8",
                          on_kv=lambda i, k, v: kv.append((k, v)))
        outs.append(harness.Output([0], toks, fp8[:, None], fp8.argmax(-1), kv))
        readings = harness.compare(ref, params, cell.widths, outs)
    verdicts = [harness.judge(r, cell.own["limits"])[0] for r in readings]
    assert verdicts == [True, False, False], readings
