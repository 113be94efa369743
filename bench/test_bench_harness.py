"""A whole run on the CPU at a small size, with the look for a chip
skipped: the result line's keys, ``correct`` true on the program, and
false when the timed path is broken underneath (each fault the cells can
have) or when the float8 control stands in the program's place, against
the cells' own limits."""
import copy
import json

import pytest
import torch

from bench import harness, traffic, weights
from bench.reference import dense_gqa


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Small CPU runs on one intra-op thread, so that a parallel test run
    keeps its cores for the other workers and their timing; and a pool of
    prompts that a small window needs, not the card's."""
    monkeypatch.setattr(traffic, "POOL_TOKENS", 1 << 17)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256}
SEED = 2**31 + 77
CELLS = ["glm4-9b.long_prompt", "mistral-nemo-12b.short_batch"]


def small_cell(name, **widths):
    """The cell with small widths and short prompts: a window of one to
    three seconds on the CPU. Its limits are the cell's own."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["widths"].update(SMALL, **widths)
    cell.mix = copy.deepcopy(cell.mix)
    if "per_request" in cell.mix["rows"]:  # long prompts: still past the flash threshold
        cell.mix["lengths"].update(min=2176, max=2432, round=128)
        # about a second a request on the CPU: the window's first two, both compared
        cell.mix.update(block=2, sample={"requests": 2, "rows": 1})
    else:
        cell.mix["lengths"].update(min=128, max=512, round=128)
        cell.mix["rows"] = {"token_budget": 2048}
    return cell


def window_s(cell):
    return 3.0 if "per_request" in cell.mix["rows"] else 1.0


def run(name, trace=False):
    cell = small_cell(name)
    return harness.run(cell, SEED, window_s(cell), trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_keeps_the_contract(name):
    res = run(name)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    cell = harness.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["checks"]) == set(cell.own["limits"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def test_traced_run_reports_per_layer_metrics_and_the_window():
    res = run(CELLS[0], trace=True)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device operation runs: at most the host-clock metric is read
    assert set(res["metrics"]) <= {"prefill_mfu.latency"}


def _zero_cache(step):
    def broken(params, batch):
        logits, cache = step(params, batch)
        for k, v in harness.program_kv(cache):
            k.zero_()
            v.zero_()
        return logits, cache
    return broken


def _half_batch(step):
    """The first half of the batch computed, its outputs given to all."""
    def broken(params, batch):
        toks = batch["tokens"]
        B = toks.shape[0]
        logits, cache = step(params, {"tokens": toks[: max(1, B // 2)]})
        src = torch.arange(B) % max(1, B // 2)

        def widen(t, dim):
            return t.index_select(dim, src)
        stack = cache["stack"]
        if "scan" in stack:
            kv = stack["scan"][0]["kv"]
            stack["scan"][0]["kv"] = {k: widen(t, 1) for k, t in kv.items()}
        else:
            stack["unroll"] = tuple({"kv": {k: widen(t, 0) for k, t in lc["kv"].items()}}
                                    for lc in stack["unroll"])
        return widen(logits, 0), cache
    return broken


def _norm_scales_dropped(step):
    """Every norm's weight left out: the scales taken as 1."""
    def broken(params, batch):
        return step(weights.with_unit_scales(params), batch)
    return broken


FAULTS = {
    "norm_dropped": ("program_step", lambda orig: lambda m, s: _norm_scales_dropped(orig(m, s))),
    "state_unchanged": ("program_step", lambda orig: lambda m, s: _zero_cache(orig(m, s))),
    "half_batch": ("program_step", lambda orig: lambda m, s: _half_batch(orig(m, s))),
    "token_altered": ("first_token", lambda orig: lambda logits: (orig(logits) + 1) % 256),
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS
                                        if not (f == "half_batch" and "long" in c)])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(harness, attr, wrap(getattr(harness, attr)))
    res = run(name)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _control_step(cell):
    """The float8 reference in the program's place: its logits, and its
    cache in the program's layout."""
    def make(model, seq):
        def step(params, batch):
            kv = []
            logits = dense_gqa.prefill(params, cell.widths, batch["tokens"], precision="fp8",
                                       on_kv=lambda i, k, v: kv.append((k, v)))
            cache = {"stack": {"unroll": tuple({"kv": {"k": k, "v": v}} for k, v in kv)}}
            return logits[:, None, :], cache
        return step
    return make


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name, monkeypatch):
    # 8 layers: float8's error grows with depth (kv_err 0.05 at 2 layers,
    # 0.10 at 8, 0.18-0.19 at the cells' 40 on the card; the program's
    # 0.004, 0.011 and 0.021-0.024)
    cell = small_cell(name, num_layers=8)
    monkeypatch.setattr(harness, "program_step", _control_step(cell))
    res = harness.run(cell, SEED, window_s(cell), False, device="cpu")
    assert res["correct"] is False
    assert res["checks"]["kv_err"]["value"] > res["checks"]["kv_err"]["limit"]


def test_run_exits_without_a_card_and_prints_no_result(capsys):
    from bench import run as cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = cli.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
