"""Share of the traced requests' device busy time (a union of intervals) in
operations launched under the program's Mamba-2 spans ``repro_torch.mamba.proj``,
``mamba.conv``, ``mamba.ssd`` and ``mamba.out`` (``spans.share_pct``).
Silent where the traces hold none of them."""
from bench import spans

NAMES = tuple(spans.PREFIX + n for n in ("mamba.proj", "mamba.conv", "mamba.ssd", "mamba.out"))


def read(run):
    return spans.share_pct(run, NAMES) or None
