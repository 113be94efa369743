"""The traffic generator: deterministic, every block the same lengths in
another order or, for a mix of fixed order, the same order, the mixes' lengths and token budgets, a p95 that lands on
one length whatever the seed, and the sample the check compares."""
import json
import math
from pathlib import Path

import pytest

from bench import traffic, yardstick

MIXES = Path(__file__).resolve().parent / "traffic"
BIG_SEED = 2**31 + 12345


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_quantile_table_lengths():
    long = mix("long_prompt")["lengths"]
    raw = traffic.quantile_table({k: v for k, v in long.items() if k != "cap"}, 4096)
    assert min(raw) == 2304 and max(raw) == 8192
    assert len(set(raw)) == 24 and all(s % 256 == 0 for s in raw)
    tab = traffic.quantile_table(long, 4096)  # capped at the node's limit
    assert max(tab) == 7680 and len(set(tab)) == 22
    assert tab.count(7680) / len(tab) == pytest.approx(0.064, abs=0.002)
    mean = sum(tab) / len(tab)
    assert 4500 < mean < 4800  # log-uniform on 2,304-8,192, capped: about 4,620
    short = traffic.quantile_table(mix("short_batch")["lengths"], 4096)
    assert min(short) == 512 and max(short) == 2048 and len(set(short)) == 13
    with pytest.raises(ValueError):
        traffic.quantile_table({"dist": "uniform", "min": 1, "max": 2, "round": 1}, 4)


@pytest.mark.parametrize("name", ["long_prompt", "short_batch"])
def test_sequence_is_deterministic_and_the_seed_only_reorders(name, monkeypatch):
    m = mix(name)
    a = traffic.sequence(m, BIG_SEED)
    assert a == traffic.sequence(m, BIG_SEED)
    b = traffic.sequence(m, BIG_SEED + 1)
    fixed = m.get("order") == "fixed"
    assert len(a) == len(b) and ([r.seq for r in a] == [r.seq for r in b]) == fixed
    k = m["block"]
    table = sorted(traffic.quantile_table(m["lengths"], k))
    for i in range(0, len(a), k):  # every block holds the same lengths
        assert sorted(r.seq for r in a[i:i + k]) == table
        assert sorted(r.seq for r in b[i:i + k]) == table
    assert [r.index for r in a] == list(range(len(a)))
    # the run's prompts fit the pool, and it holds many windows' worth
    assert sum(r.tokens for r in a) <= traffic.POOL_TOKENS
    assert sum(r.tokens for r in a) > traffic.POOL_TOKENS - k * 16384
    whole = traffic.sequence(m, 1)
    monkeypatch.setattr(traffic, "POOL_TOKENS", 1)
    assert traffic.sequence(m, 1) == whole[:k]


def test_long_prompt_blocks_are_the_flash_lengths():
    m = mix("long_prompt")
    reqs = traffic.sequence(m, BIG_SEED)
    assert all(r.rows == 1 for r in reqs)
    block = sorted(r.seq for r in reqs[:24])
    assert block[0] == 2304 and block[-3:] == [7168, 7680, 7680]
    assert sum(block) / 24 == pytest.approx(4629, rel=0.01)
    assert min(block) > 2048  # every prompt past the flash threshold


@pytest.mark.parametrize("seed", [1, 7, BIG_SEED, 2**31 + 999])
def test_p95_lands_on_one_length_whatever_the_window(seed):
    """In a window of 100-300 requests (a long cell's 45 s) the
    nearest-rank p95 of the lengths served is the cap, 7,680, on every
    seed, and its rank lies inside the capped prompts with at least three
    of them on either side (four from 140 requests): the tail is a middle
    one of the longest prompts' times, not the slowest of them."""
    seqs = [r.seq for r in traffic.sequence(mix("long_prompt"), seed)]
    for n in range(100, 301):
        assert yardstick.percentile(seqs[:n], 95) == 7680
        rank = math.ceil(0.95 * n)  # 1-based, ascending
        capped = seqs[:n].count(7680)
        assert n - rank >= 4 and rank - (n - capped) >= (3 if n < 140 else 4)


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_fixed_order_leaves_out_the_same_middle_lengths(seed):
    """short_batch sends every block in one order, from both ends inwards:
    a window that ends inside a block leaves out the same lengths on every
    seed, the ones nearest the middle first."""
    m = mix("short_batch")
    seqs = [r.seq for r in traffic.sequence(m, seed)]
    k = m["block"]
    assert seqs[:k] == [512, 1920, 640, 1536, 768, 1280, 896, 1152]
    assert all(seqs[i:i + k] == seqs[:k] for i in range(0, len(seqs), k))
    assert seqs == [r.seq for r in traffic.sequence(m, seed + 1)]
    with pytest.raises(ValueError):
        traffic.sequence(dict(m, order="sorted"), seed)


def test_short_batch_token_budget():
    m = mix("short_batch")
    reqs = traffic.sequence(m, BIG_SEED)
    for r in reqs:
        assert r.rows == 16384 // r.seq and r.tokens <= 16384
        assert r.tokens > 16384 - r.seq
    assert traffic.rows_for(m, 2048) == 8 and traffic.rows_for(m, 512) == 32
    assert max(r.seq for r in reqs) == 1920 and min(r.seq for r in reqs) == 512


def test_sample_holds_the_longest_and_both_halves_of_a_batch():
    m = mix("long_prompt")
    reqs = traffic.sequence(m, BIG_SEED)
    picked = traffic.sample(m, reqs, BIG_SEED)
    assert len(picked) == m["sample"]["requests"]
    assert reqs[picked[0][0]].seq == max(r.seq for r in reqs)
    assert all(idx < m["block"] for idx, _ in picked)
    assert picked == traffic.sample(m, reqs, BIG_SEED)
    s = mix("short_batch")
    reqs = traffic.sequence(s, BIG_SEED)
    for seed in range(20):
        for idx, rows in traffic.sample(s, reqs, seed):
            r = reqs[idx]
            assert idx < s["block"]
            assert len(rows) == min(r.rows, s["sample"]["rows"])
            assert min(rows) < r.rows // 2 <= max(rows)
