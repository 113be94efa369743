"""The flash kernel's share of its roofline: Σ bound over Σ device time of
its launches in the device-only traced requests. Bound = max(FLOP / 989
TFLOP/s, bytes / 3.35 TB/s) a call, FLOP = 4·B·H·D·S²/2, bytes = q, k, v
read once and o written once (bf16). Silent where the traced prefills
launched no flash kernel, or not one a layer."""
from bench import yardstick

KERNEL = "fa_fwd"


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = t.kernels(KERNEL)
    traced = [s for s in run.served if s.traced == "device"]
    if not calls or not traced:
        return None
    layers = run.widths["num_layers"]
    if len(calls) != layers * len(traced):
        return None
    bound = sum(layers * yardstick.bound_s(*yardstick.flash_call(run.widths, s.rows, s.seq))
                for s in traced)
    took = sum(o.end - o.start for o in calls)
    return 100.0 * bound / took
