"""Named spans at the program's layer boundaries, in the profiler's trace.

While a ``torch.profiler`` session runs, ``span(name)`` is a record
function named ``"repro_torch." + name``, so the span lands in that
session's trace on the clock of the kernels it launches, nested by
containment. It is ``torch._C._profiler._RecordFunctionFast``, the C++
record function that PyTorch's own compiled kernels use: the trace lists it
as a ``cpu_op``, not a ``user_annotation``, and on an H100 host it costs
about 1 µs a span where the session records no CPU activity (as the
benchmark's device-only stretch does) and 2 µs where it does, against
``torch.profiler.record_function``'s 12 µs either way. Otherwise it is one
shared no-op context: a span costs one attribute read and builds no record
function.

The spans on the prefill path (``serve.prefill`` ⊃ ``model.embed``,
``model.stack`` ⊃ each layer's ``layer.norm`` (two), its mixer's spans,
its MLP's or MoE's, and ``model.head``) are named by layer, not by layer
index; ``bench/spans.py`` attributes each device kernel to the innermost
one open when it was launched. The mixers': an attention layer's
``attention.qkv``, ``attention.rope``, ``attention.cache``,
``attention.core`` and ``attention.out``; a Mamba-2 layer's
``mamba.proj`` (the five in-projections), ``mamba.conv``, ``mamba.ssd``
(the scan and the D skip) and ``mamba.out`` (the gated norm and the
out-projection). After the mixer a dense ``mlp``, or ``moe`` ⊃
``moe.route`` (router product, softmax, top k, aux losses),
``moe.dispatch`` (the sort or slots and the gather of rows), ``moe.experts`` (the expert products and activation),
``moe.shared`` (the shared expert) and ``moe.combine`` (un-permute,
gates, the sum over k and the shared expert's add).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler is on."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
