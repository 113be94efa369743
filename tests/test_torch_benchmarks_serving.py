"""fig20 (the KV serving plane), fig21 (pushdown) and fig22 (MemTier) of
``benchmarks_torch`` against the JAX package's on the CPU, as
``test_torch_benchmarks.py`` holds the other figures: two runs of the JAX
module and one of the port's, every functional claim PASSing, every row
but the named racy ones equal value for value. fig20's dedupe hit rates
and bytes stored, and fig21's bytes on the wire and row counts, are
asserted by name. fig20's ``--full-width`` path runs at
``qwen3-1.7b:smoke`` (a 2,304-token prompt, past the flash threshold) on
the main path's volume: the fetched cache equals the one put and the
stored first token the recomputed one, bit for bit.
"""
import torch
from torch_bench_util import TC, compare_with_reference, rows


def _by_name(port):
    return {r[0]: r for r in port}


def test_fig20_rows_match_the_reference(monkeypatch):
    port = _by_name(compare_with_reference("fig20_kv_serving", monkeypatch))
    assert port["fig20/dedupe_hit_rate"][1] == "prefix=0.850;round_robin=0.575;random=0.525"
    assert port["claim/fig20/prefix_moves_fewest_bytes"][2] == (
        "store bytes prefix=99264 rr=281248 rnd=314336")
    assert port["claim/fig20/offloaded_cache_identical"][1] == "PASS"


def test_fig21_rows_match_the_reference(monkeypatch):
    port = _by_name(compare_with_reference("fig21_pushdown", monkeypatch))
    assert port["fig21/bytes_blockship"][1] == "630784"
    assert [port[f"fig21/bytes_pushdown/{t}"][1:] for t in ("sel01", "sel10", "sel50")] == [
        ("44616", "11 rows, 14.14x fewer bytes"), ("85282", "178 rows, 7.40x fewer bytes"),
        ("230899", "777 rows, 2.73x fewer bytes")]
    assert port["claim/fig21/rows_identical_sel10"][2] == "178 rows local vs 178 pushdown"


def test_fig22_rows_match_the_reference(monkeypatch):
    compare_with_reference("fig22_memtier", monkeypatch)


def test_fig20_full_width_path_at_smoke_width(monkeypatch):
    from benchmarks_torch import fig20_kv_serving as F

    monkeypatch.setattr(TC, "DEVICE", "cpu")
    got = rows(TC, _Call(lambda: F.full_width("qwen3-1.7b:smoke", batch=2, prompt_len=2304,
                                              reps=1)), ["fig20_kv_serving"], monkeypatch)
    assert [r[0] for r in got] == [
        "fig20/full_width/plane", "fig20/full_width/ttft_ms",
        "claim/fig20/full_width/attach_beats_recompute_2x",
        "claim/fig20/full_width/offloaded_cache_identical"]
    assert got[0][1] == "blocks=524288;stripes=4;chunk_blocks=256"
    assert "B=2 S=2304" in got[1][2]
    assert got[3][1] == "PASS"


def test_fig20_identity_check_sees_one_bit(monkeypatch):
    """``identical`` refuses a fetched cache one bit off the one put, and a
    first token that differs."""
    from benchmarks_torch import fig20_kv_serving as F

    cache = {"k": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
             "v": (torch.zeros(2), torch.ones(2, dtype=torch.float32))}
    tok = torch.tensor([3, 5], dtype=torch.int32)
    res = {"token": tok, "first_token": tok[:, None], "fetched": {
        "k": cache["k"].clone(), "v": tuple(x.clone() for x in cache["v"])}}
    assert F.identical(cache, res)
    res["fetched"]["v"][0][1] = -0.0  # equal as a value, not as bits
    assert not F.identical(cache, res)
    res["fetched"]["v"][0][1] = 0.0
    res["first_token"] = torch.tensor([3, 6], dtype=torch.int32)
    assert not F.identical(cache, res)


class _Call:
    """A module stand-in whose ``main()`` is ``fn()``."""

    def __init__(self, fn):
        self.main = fn
