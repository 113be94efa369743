"""Wrapper of the Hopper SSD scan (``csrc/ssd.cu``): the Mamba-2 mixer's
chunked scan and its D skip, forward only, y rounded once to x's dtype.

It replaces no TPU kernel (the JAX package runs the scan as plain jnp) but
``models.ssm.ssd_chunked`` plus the D skip, on the prefill path, where the
plain PyTorch form spends most of a hybrid model's device time. ``takes``
says which calls the kernel serves; everything else keeps ``ssd_chunked``.

x is read in place through its (batch, token) strides (the model hands a
view of the conv's output), as are B and C; heads and the head dim must be
contiguous and every row start 16-byte aligned. A CPU tensor takes the
plain version (``ref.ssd_scan_ref``); a CUDA tensor launches the kernel or
raises. The wrapper allocates the outputs and the kernel's scratch: the
per-chunk cumulative sums, C·Bᵀ, the chunk states in f32 and the entering
states in three bf16 terms (327 MB at granite's widths and 7,680 tokens).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# calls that reached the kernel since the last reset (four launches each)
CALLS = 0

CHUNK = 256
HEAD_DIM = 64
STATES = (64, 128)


def takes(device_type: str, records: bool, dtype: torch.dtype, head_dim: int, d_state: int,
          chunk: int, seq: int) -> bool:
    """Whether the kernel serves a scan of these properties: CUDA tensors
    that autograd does not record through, x in bf16, P 64, N 64 or 128,
    chunks of 256 and a sequence a whole number of them."""
    return (device_type == "cuda" and not records and dtype == torch.bfloat16
            and head_dim == HEAD_DIM and d_state in STATES and chunk == CHUNK
            and seq % CHUNK == 0)


def properties(x, Bm, chunk: int, *others):
    """What ``takes`` reads of a scan's operands x (B,S,H,P) and Bm
    (B,S,N) and the chunk; autograd records if it records through any of
    them or of ``others`` (None entries skipped)."""
    records = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, Bm) + others)
    return x.device.type, records, x.dtype, x.shape[-1], Bm.shape[-1], chunk, x.shape[1]


def _fn():
    return bind(build.load("ssd"))


def bind(lib: ctypes.CDLL):
    """``ssd_forward`` of a loaded library, with its C signature set."""
    fn = lib.ssd_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _rows(name: str, t: torch.Tensor):
    """(batch, token) strides of ``t`` (B, S, ...), whose elements a token
    lie contiguous; raises where the kernel cannot read it in place (16-byte
    rows)."""
    ok, want = t.data_ptr() % 16 == 0, 1
    for n, s in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        ok &= n == 1 or s == want
        want *= n
    ok &= all(s % (16 // t.element_size()) == 0 for s in t.stride()[:2])
    if not ok:
        raise ValueError(f"ssd_scan: {name} of shape {tuple(t.shape)}, strides {t.stride()} "
                         "is a layout the kernel cannot read in place (a token's elements "
                         "contiguous, 16-byte strides and start)")
    return t.stride(0), t.stride(1)


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int, h0=None):
    """x (B,S,H,P), dt (B,S,H) f32, A and D (H,) f32, Bm and Cm (B,S,N),
    h0 (B,H,N,P) f32 or None → (y (B,S,H,P) in x's dtype, with the D skip,
    rounded once; the state after the last token (B,H,N,P) f32)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    props = properties(x, Bm, chunk, dt, A, Cm, D, h0)
    if not takes(*props):
        raise ValueError(f"ssd_scan: the kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, N {N}, chunk {chunk} (records grad: {props[1]})")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype or Cm.shape != Bm.shape:
        raise ValueError("ssd_scan: B and C must match each other and x's dtype")
    f32 = (dt, A, D) + ((h0,) if h0 is not None else ())
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in f32):
        raise ValueError("ssd_scan: dt, A, D and h0 must be contiguous float32")
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,) or (
            h0 is not None and h0.shape != (Bsz, H, N, P)):
        raise ValueError("ssd_scan: dt (B,S,H), A and D (H,), h0 (B,H,N,P)")
    xs, bs, cs = _rows("x", x), _rows("B", Bm), _rows("C", Cm)
    nc = S // chunk
    dev = x.device
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    h_last = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
    cum = torch.empty((Bsz, nc, H, 2, chunk), dtype=torch.float32, device=dev)
    cb = torch.empty((Bsz, nc, chunk, chunk), dtype=torch.float32, device=dev)
    states = torch.empty((Bsz, nc, H, N, P), dtype=torch.float32, device=dev)
    hs = torch.empty((Bsz, nc, H, 3, N, P), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), *xs, Bm.data_ptr(), *bs, Cm.data_ptr(), *cs,
                    dt.data_ptr(), A.data_ptr(), D.data_ptr(),
                    h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                    h_last.data_ptr(), cum.data_ptr(), cb.data_ptr(), states.data_ptr(),
                    hs.data_ptr(), Bsz, S, H, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    global CALLS
    CALLS += 1
    return y, h_last
