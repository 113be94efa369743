"""The program's spans (``repro_torch.spans``) on the CPU: under
``torch.profiler`` a prefill records ``serve.prefill`` ⊃ ``model.embed``,
``model.stack`` ⊃ eight sublayer spans a layer, and ``model.head``, nested
by containment, with every ATen op of the prefill inside a leaf span but
for the stack's and the model's own bookkeeping; with the profiler off a
span builds no ``RecordFunction``."""
import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.models.config import get_config
from repro_torch.models.layers import FLASH_THRESHOLD
from repro_torch.models.model import build_model
from repro_torch.serve.step import make_decode_step, make_prefill_step

LAYERS = 2
SUBLAYERS = {"layer.norm": 2, "attention.qkv": 1, "attention.rope": 1, "attention.cache": 1,
             "attention.core": 1, "attention.out": 1, "mlp": 1}
LEAVES = {"model.embed", "model.head", *SUBLAYERS}
# ATen ops of a prefill that no leaf span holds, with the ops they call: the
# stacked params' unbind, the residual adds, the MoE aux losses' zeros and
# sums, the stacked cache's torch.stack, the positions, the last position's
# slice and the cache's position
OUTSIDE_LEAVES = {
    "aten::unbind", "aten::select", "aten::as_strided",
    "aten::add", "aten::zeros", "aten::empty", "aten::zero_",
    "aten::stack", "aten::cat", "aten::narrow", "aten::unsqueeze", "aten::view",
    "aten::resize_", "aten::arange", "aten::expand", "aten::slice", "aten::full",
    "aten::fill_",
}


@pytest.fixture(scope="module")
def small():
    """A dense GQA model of two layers in the stacked layout the benchmark's
    configurations use (4 heads over 2 KV heads, partial rotary)."""
    cfg = get_config("glm4-9b:smoke").with_(num_layers=LAYERS, scan_layers=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(7))


def _trace(tmp_path, fn):
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return out, events


def _program_spans(events):
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(spans.PREFIX):])
                   for e in events if e["name"].startswith(spans.PREFIX)),
                  key=lambda s: (s[0], -s[1]))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _parent(sp, all_spans):
    """The innermost other span that holds ``sp``, or None."""
    holders = [o for o in all_spans if o is not sp and _inside(sp, o)]
    return max(holders, key=lambda o: o[0])[2] if holders else None


@pytest.mark.parametrize("seq", [FLASH_THRESHOLD - 48, FLASH_THRESHOLD + 64],
                         ids=["einsum", "flash"])
def test_prefill_records_the_layer_spans_nested(small, seq, tmp_path):
    model, params = small
    toks = torch.randint(0, model.cfg.vocab_size, (1, seq), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seq))
    _, events = _trace(tmp_path, lambda: make_prefill_step(model, seq)(params, {"tokens": toks}))
    sp = _program_spans(events)
    counts = Counter(name for _, _, name in sp)
    assert counts == Counter({"serve.prefill": 1, "model.embed": 1, "model.stack": 1,
                              "model.head": 1,
                              **{k: n * LAYERS for k, n in SUBLAYERS.items()}})
    parents = {(s[0], s[2]): _parent(s, sp) for s in sp}
    for (_, name), parent in parents.items():
        want = {"serve.prefill": None, "model.embed": "serve.prefill",
                "model.stack": "serve.prefill", "model.head": "serve.prefill"}
        assert parent == want.get(name, "model.stack"), name
    order = [name for _, _, name in sp if name in SUBLAYERS]
    assert order == ["layer.norm", "attention.qkv", "attention.rope", "attention.cache",
                     "attention.core", "attention.out", "layer.norm", "mlp"] * LAYERS

    prefill = next(s for s in sp if s[2] == "serve.prefill")
    leaves = [s for s in sp if s[2] in LEAVES]
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "cpu_op" and _inside((e["ts"], e["ts"] + e["dur"]), prefill)]
    outside = {name for s, e, name in ops if name.startswith("aten::")
               and not any(_inside((s, e), leaf) for leaf in leaves)}
    assert outside <= OUTSIDE_LEAVES
    core = [s for s in sp if s[2] == "attention.core"]
    flash = [o for o in ops if o[2] == "repro_torch::flash_attention"]
    assert len(flash) == (LAYERS if seq > FLASH_THRESHOLD else 0)
    assert all(any(_inside(f, c) for c in core) for f in flash)
    einsum = [o for o in ops if o[2] == "aten::softmax"
              and not any(_inside(o, f) for f in flash)]  # the einsum path's own
    assert len(einsum) == (0 if seq > FLASH_THRESHOLD else LAYERS)
    assert all(any(_inside(o, c) for c in core) for o in einsum)


def test_decode_step_records_the_cache_write_and_the_attention(small, tmp_path):
    model, params = small
    toks = torch.randint(0, model.cfg.vocab_size, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        _, cache = make_prefill_step(model, 32)(params, {"tokens": toks})
    step = make_decode_step(model)
    _, events = _trace(tmp_path, lambda: step(params, cache, toks[:, -1:]))
    counts = Counter(name for _, _, name in _program_spans(events))
    assert counts == Counter({"model.embed": 1, "model.stack": 1, "model.head": 1,
                              **{k: n * LAYERS for k, n in SUBLAYERS.items()}})


def test_spans_build_nothing_with_the_profiler_off(small, monkeypatch):
    model, params = small
    toks = torch.randint(0, model.cfg.vocab_size, (1, 64), dtype=torch.int32)
    with torch.inference_mode():
        want, _ = make_prefill_step(model, 64)(params, {"tokens": toks})

    def refuse(*a, **k):
        raise AssertionError("a span built a RecordFunction with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span("a") is spans.span("b")
    with torch.inference_mode():
        got, _ = make_prefill_step(model, 64)(params, {"tokens": toks})
    assert torch.equal(got, want)
