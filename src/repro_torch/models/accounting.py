"""Static FLOPs accounting for scan bodies (port of
``src/repro/models/accounting.py``).

Model code calls ``add_scan_flops`` with the *analytic* FLOPs of the work
that the JAX package runs inside a ``lax.scan`` body (a chunked attention,
the mLSTM chunk loop, the sLSTM recurrence), which XLA's cost analysis
counts once. ``count_scan_flops`` runs a function and returns the total it
declared.

JAX traces the body of a scan over stacked layers once and multiplies what
it declares by ``scan_scope(n)``. The port runs those periods as a Python
loop, so each period declares its own FLOPs and the stack enters no
``scan_scope``: wrapping the loop in one would count them n² times.
``count_scan_flops`` totals what JAX's ``measure_scan_flops`` totals for
the same call. ``measure_scan_flops`` is the abstract twin, the
counterpart of JAX's ``jax.eval_shape``: it runs the call under a
``FakeTensorMode``, so that it allocates nothing, on ``meta`` tensors or
fake ones (a plan's abstract arguments).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_ACC: contextvars.ContextVar = contextvars.ContextVar("scan_flops", default=None)
_MULT: contextvars.ContextVar = contextvars.ContextVar("scan_mult", default=1.0)


def add_scan_flops(flops: float) -> None:
    acc = _ACC.get()
    if acc is not None:
        acc[0] += float(flops) * _MULT.get()


@contextlib.contextmanager
def scan_scope(trip_count: int):
    """Everything declared inside counts ``trip_count`` times (JAX: a body
    traced once and executed that many times)."""
    tok = _MULT.set(_MULT.get() * trip_count)
    try:
        yield
    finally:
        _MULT.reset(tok)


def count_scan_flops(fn, *args, **kw) -> float:
    """Run ``fn(*args, **kw)`` and return the scan-body FLOPs it declared.
    It counts what runs: a forward, as JAX's abstract evaluation does; a
    rematerialised backward would declare its recomputed forward again."""
    acc = [0.0]
    tok = _ACC.set(acc)
    try:
        fn(*args, **kw)
    finally:
        _ACC.reset(tok)
    return acc[0]


def measure_scan_flops(fn, *abstract_args, **kw) -> float:
    """Run ``fn`` on abstract arguments (``meta`` tensors, or real ones
    that are only read for their shapes) under a ``FakeTensorMode`` and
    return the scan-body FLOPs it declares; nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_map

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        args = tree_map(lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor)
                        else t, abstract_args)
        return count_scan_flops(fn, *args, **kw)
