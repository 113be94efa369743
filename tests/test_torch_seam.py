"""The seam between the port's models and its kernels, on the CPU.

``models.layers.attention_path`` decides, for every call of
``apply_attention``, whether the flash kernel, the chunked twin or the
einsum attention runs it; the table below is that rule, row for row.
``kernels.build.launch`` is the one place that calls a kernel's C entry
point: the stream appended, the return checked, the call counted by entry
in ``build.LAUNCHES``. A stand-in entry takes the library's place here.
"""
import contextlib
import ctypes
import types
from collections import Counter

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.models import layers as L

PAST = L.FLASH_THRESHOLD + 256
BF16, F32 = torch.bfloat16, torch.float32

# id: (mode, causal, cross, seq, head_dim, dtype, records) -> path
PATHS = {
    "decode": (("decode", True, False, 1, 128, BF16, False), "einsum"),
    "cross_prefill": (("prefill", False, True, 256, 128, BF16, False), "einsum"),
    "cross_past": (("prefill", False, True, PAST, 128, BF16, False), "einsum"),
    "prefill_short_bf16": (("prefill", True, False, 256, 128, BF16, False), "kernel"),
    "prefill_short_f32_d96": (("prefill", True, False, 512, 96, F32, False), "kernel"),
    "prefill_at_threshold": (("prefill", True, False, L.FLASH_THRESHOLD, 64, BF16, False),
                             "kernel"),
    "prefill_past": (("prefill", True, False, PAST, 128, BF16, False), "kernel"),
    "prefill_past_d16": (("prefill", True, False, PAST, 16, F32, False), "kernel"),
    "encoder_past": (("train", False, False, PAST, 64, BF16, False), "kernel"),
    "encoder_past_d16": (("train", False, False, PAST, 16, F32, False), "kernel"),
    "prefill_past_records": (("prefill", True, False, PAST, 128, BF16, True), "twin"),
    "train_past": (("train", True, False, PAST, 128, BF16, False), "twin"),
    "train_past_records": (("train", True, False, PAST, 128, BF16, True), "twin"),
    "encoder_past_records": (("train", False, False, PAST, 64, BF16, True), "twin"),
    "prefill_short_d16": (("prefill", True, False, 256, 16, F32, False), "einsum"),
    "prefill_at_threshold_d16": (("prefill", True, False, L.FLASH_THRESHOLD, 16, BF16, False),
                                 "einsum"),
    "prefill_short_f16": (("prefill", True, False, 256, 128, torch.float16, False), "einsum"),
    "prefill_short_records": (("prefill", True, False, 256, 128, BF16, True), "einsum"),
    "train_short": (("train", True, False, 256, 128, BF16, False), "einsum"),
    "encoder_short": (("train", False, False, L.FLASH_THRESHOLD, 64, BF16, False), "einsum"),
}


@pytest.mark.parametrize("case", list(PATHS))
def test_attention_path(case):
    (mode, causal, cross, seq, head_dim, dtype, records), want = PATHS[case]
    assert L.attention_path(mode, causal=causal, cross=cross, seq=seq, head_dim=head_dim,
                            dtype=dtype, records=records) == want


class _Entry:
    """A C entry point's stand-in: returns ``ret``, keeps its calls and
    counts how often its signature is set."""

    def __init__(self, ret):
        self.ret, self.calls, self.sets, self._argtypes, self.restype = ret, [], 0, None, None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.fixture
def fake_lib(monkeypatch):
    """``build.load("fake")`` gives a library of two stand-in entries, ``ok``
    (returns 0) and ``bad`` (returns cudaError 700); the device context is
    recorded and the current stream is 1234; ``build.LAUNCHES`` starts
    empty."""
    lib = types.SimpleNamespace(ok=_Entry(0), bad=_Entry(700), devices=[])

    def load(name):
        assert name == "fake"
        return lib

    def device(dev):
        lib.devices.append(dev)
        return contextlib.nullcontext()

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    return lib


def test_launch_appends_the_stream_and_counts_by_entry(fake_lib):
    sig = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    build.launch("fake", "ok", sig, "cuda:1", 7, 8)
    build.launch("fake", "ok", sig, "cuda:1", 9, 10)
    ok = fake_lib.ok
    assert ok.calls == [(7, 8, 1234), (9, 10, 1234)] and fake_lib.devices == ["cuda:1"] * 2
    assert ok.sets == 1 and ok.argtypes == sig and ok.restype is ctypes.c_int
    assert build.LAUNCHES == Counter({"ok": 2})


def test_launch_raises_naming_the_entry_and_counts_nothing(fake_lib):
    with pytest.raises(RuntimeError, match=r"^bad: .*cudaError 700$"):
        build.launch("fake", "bad", [ctypes.c_void_p], "cuda:0")
    assert fake_lib.bad.calls == [(1234,)] and build.LAUNCHES["bad"] == 0
    build.launch("fake", "ok", [ctypes.c_void_p], "cuda:0")
    assert build.LAUNCHES == Counter({"ok": 1})
