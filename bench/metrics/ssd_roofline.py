"""The SSD scan kernel's share of its roofline: Σ bound over Σ device time
of its launches in the device-only traced requests. One call of the scan,
a Mamba layer's, is four launches (kernels under ``repro_ssd::``). Bound =
max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s) a call: FLOP = (N·L + H·P·L +
4·H·N·P) a token, the SSD term of ``granite_hybrid.prefill_flops`` without
the conv's taps (L = min(chunk, seq)); bytes = x and y in bf16, B and C in
bf16, dt and dt·A in f32, and the final state in f32. Silent where the
traced prefills launched no SSD kernel, or not four a Mamba layer: in the
dense cells, and where the program runs the scan in plain PyTorch."""
from bench import yardstick

KERNEL = "repro_ssd::"
LAUNCHES_PER_CALL = 4


def ssd_call(w: dict, rows: int, seq: int):
    """(FLOP, bytes) of one Mamba layer's scan over ``rows`` prompts of
    ``seq`` tokens at the widths ``w``."""
    mc = w["mamba"]
    di, N, P = mc["expand"] * w["d_model"], mc["d_state"], mc["head_dim"]
    H, L = di // P, min(mc["chunk"], seq)
    tokens = rows * seq
    flops = (N * L + H * P * L + 4 * H * N * P) * tokens
    nbytes = tokens * (2 * 2 * H * P + 2 * 2 * N + 2 * 4 * H) + 4 * rows * H * N * P
    return flops, nbytes


def mamba_layers(w: dict) -> int:
    pat = w["block_pattern"]
    return sum(pat[i % len(pat)] != "attn" for i in range(w["num_layers"]))


def read(run):
    t = run.trace
    if t is None or "mamba" not in run.widths:
        return None
    calls = t.kernels(KERNEL)
    traced = [s for s in run.served if s.traced == "device"]
    if not calls or not traced:
        return None
    layers = mamba_layers(run.widths)
    if len(calls) != LAUNCHES_PER_CALL * layers * len(traced):
        return None
    bound = sum(layers * yardstick.bound_s(*ssd_call(run.widths, s.rows, s.seq))
                for s in traced)
    took = sum(o.end - o.start for o in calls)
    return 100.0 * bound / took
