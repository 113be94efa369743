"""Share of the traced requests' device busy time (a union of intervals) in
operations launched under the program's span ``repro_torch.attention.core``:
the attention itself, flash kernel or einsum path (``spans.share_pct``).
Silent where the traces hold no program span."""
from bench import spans


def read(run):
    return spans.share_pct(run, spans.CORE)
