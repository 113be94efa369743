"""Share of the traced requests' device busy time (a union of intervals) in
operations launched under the program's MoE spans: ``repro_torch.moe``
(the sublayer) and its ``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.shared`` and ``moe.combine`` (``spans.share_pct``). Silent where the
traces hold none of them."""
from bench import spans

NAMES = tuple(spans.PREFIX + n for n in (
    "moe", "moe.route", "moe.dispatch", "moe.experts", "moe.shared", "moe.combine"))


def read(run):
    return spans.share_pct(run, NAMES) or None
