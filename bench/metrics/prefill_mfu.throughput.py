"""The prefill's share of the card's bf16 peak: the benchmark's own FLOP
count over the host time of the prefills (``readers.prefill_mfu_pct``)."""
from bench import readers


def read(run):
    return readers.prefill_mfu_pct(run)
