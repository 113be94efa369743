"""Share of the traced requests' device busy time (a union of intervals) in
operations launched under the program's spans ``repro_torch.layer.norm``
(the f32 RMSNorms) and ``repro_torch.attention.rope`` (``spans.share_pct``).
Silent where the traces hold no program span."""
from bench import spans


def read(run):
    return spans.share_pct(run, spans.NORM_ROPE)
