"""The seam between the port's models and its kernels, on the CPU.

``models.layers.attention_path`` decides, for every call of
``apply_attention``, whether the flash kernel, the chunked twin or the
einsum attention runs it; the table below is that rule, row for row.
``kernels.rmsnorm.takes`` (asked through ``ops.rms_norm_takes`` by
``models.layers.apply_norm``) decides whether a norm runs the RMSNorm
kernel or the plain formula; ``NORMS`` is that rule, row for row.
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

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rmsnorm as krms
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


# id: the change to a norm the kernel takes (glm4-9b's ln1 in a prefill) -> path
NORM_TAKEN = dict(device_type="cuda", records=False, dtype=BF16, scale_dtype=BF16, d=4096,
                  bias=False, rows_split=False)
NORMS = {
    "prefill_bf16": ({}, "kernel"),
    "scale_f32": ({"scale_dtype": F32}, "kernel"),
    "nemo_width": ({"d": 5120}, "kernel"),
    "narrow": ({"d": 8}, "kernel"),
    "widest": ({"d": krms.MAX_D}, "kernel"),
    "cpu": ({"device_type": "cpu"}, "plain"),
    "meta": ({"device_type": "meta"}, "plain"),
    "records": ({"records": True}, "plain"),
    "f32": ({"dtype": F32}, "plain"),
    "f16": ({"dtype": torch.float16}, "plain"),
    "scale_f16": ({"scale_dtype": torch.float16}, "plain"),
    "bias": ({"bias": True}, "plain"),
    "d_not_multiple_of_8": ({"d": 4100}, "plain"),
    "d_past_widest": ({"d": krms.MAX_D + 8}, "plain"),
    "rows_split_across_devices": ({"rows_split": True}, "plain"),
}


@pytest.mark.parametrize("case", list(NORMS))
def test_rms_norm_path(case):
    change, want = NORMS[case]
    assert ("kernel" if krms.takes(**{**NORM_TAKEN, **change}) else "plain") == want


@pytest.mark.parametrize("grad", [False, True])
def test_rms_norm_takes_reads_the_operands(monkeypatch, grad):
    seen = []
    monkeypatch.setattr(krms, "takes", lambda *a: seen.append(a) or True)
    x = torch.zeros((2, 3, 64), dtype=BF16)
    scale = torch.ones(64, requires_grad=grad)
    assert ops.rms_norm_takes(x, scale) and ops.rms_norm_takes(x, scale, torch.zeros(64))
    assert seen == [("cpu", grad, BF16, F32, 64, False, False),
                    ("cpu", grad, BF16, F32, 64, True, False)]
    with torch.no_grad():
        ops.rms_norm_takes(x, scale)
    assert seen[-1][1] is False  # nothing records under no_grad
    monkeypatch.undo()
    assert not ops.rms_norm_takes(x, scale)  # a CPU tensor keeps the plain formula


@pytest.mark.parametrize("placements,ndim,whole", [
    ("R", 3, True), ("S0", 3, True), ("S1,R", 3, True), ("S0,S1", 3, True),
    ("S2", 3, False), ("S-1", 3, False), ("R,S2", 3, False), ("P", 3, False),
    ("S1,P", 3, False), ("R,R", 1, True), ("S0", 1, False)])
def test_whole_rows_of_a_dtensor(placements, ndim, whole):
    """A DTensor is normed shard by shard only where every device holds
    whole rows: replicated, or split along a dim other than the last; the
    scale (one dim) only replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    make = {"R": lambda: Replicate(), "P": lambda: Partial()}
    pl = [make[p]() if p in make else Shard(int(p[1:])) for p in placements.split(",")]
    assert krms.whole_rows(pl, ndim) is whole


def _norm_before(p, x, eps=1e-5):
    """``apply_norm`` as the port wrote it before the kernel, kept here as
    the yardstick of the plain path."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


@pytest.mark.parametrize("bias", [False, True], ids=["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype,scale_dtype,d", [(BF16, BF16, 4096), (BF16, F32, 96),
                                                 (F32, F32, 100), (BF16, BF16, 12)])
def test_apply_norm_on_cpu_is_the_plain_formula(dtype, scale_dtype, d, bias):
    g = torch.Generator().manual_seed(d)
    x = (3 * torch.randn((2, 7, d), generator=g)).to(dtype)
    p = {"scale": (1 + 0.1 * torch.randn(d, generator=g)).to(scale_dtype)}
    if bias:
        p["bias"] = torch.randn(d, generator=g).to(scale_dtype)
    got = L.apply_norm(p, x)
    assert got.dtype == dtype and torch.equal(got, _norm_before(p, x))
    assert torch.equal(L.apply_norm(p, x[:, -1:]), _norm_before(p, x[:, -1:]))


def test_apply_norm_asks_the_rule_once_and_sends_the_kernel_its_operands(monkeypatch):
    asked, ran = [], []
    monkeypatch.setattr(ops, "rms_norm_takes", lambda *a: asked.append(a) or True)
    monkeypatch.setattr(ops, "rms_norm", lambda x, s, eps: ran.append((x, s, eps)) or "y")
    x, p = torch.zeros((1, 4, 16), dtype=BF16), {"scale": torch.ones(16, dtype=BF16)}
    assert L.apply_norm(p, x) == "y"
    assert len(asked) == 1 and asked[0][0] is x and asked[0][1] is p["scale"]
    assert asked[0][2] is None and ran == [(x, p["scale"], 1e-5)]


def test_rms_norm_wrapper_reads_the_head_view_in_place():
    """The head's last position ``x[:, -1:]`` of a batch is read through its
    row stride; a layout whose rows do not collapse to one stride, or a start
    off 16 bytes, is copied."""
    x = torch.zeros((4, 10, 64), dtype=BF16)
    rows, stride = krms._rows(x[:, -1:])
    assert rows.data_ptr() == x[:, -1:].data_ptr() and rows.shape == (4, 64)
    assert stride == 10 * 64
    rows, stride = krms._rows(x[:1, -1:])
    assert rows.shape == (1, 64) and stride == 64
    rows, stride = krms._rows(x[:, :, :32].transpose(0, 1))
    assert rows.is_contiguous() and stride == 32
    flat = torch.zeros(64 * 3 + 4, dtype=BF16)
    rows, stride = krms._rows(flat[4:].view(3, 64))  # 8 bytes past the start
    assert rows.data_ptr() % 16 == 0 and stride == 64


def test_rms_norm_on_cpu_is_the_plain_formula():
    g = torch.Generator().manual_seed(3)
    x, s = torch.randn((3, 5, 40), generator=g).to(BF16), torch.randn(40, generator=g)
    assert torch.equal(ops.rms_norm(x, s), ref.rms_norm_ref(x, s, 1e-5))


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
