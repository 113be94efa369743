"""Wrapper of the Hopper preprocess kernel (``csrc/preprocess.cu``).

It replaces the Pallas banded-matmul kernel ``src/repro/kernels/preprocess.py``
(``_prep_kernel`` / ``preprocess_plane``) and the JAX wrapper's resize
operators (``src/repro/kernels/ops.py`` ``preprocess_image``): the kernel
gathers four pixels per output element in float64, as the storage node's
numpy path does, and reads its input and writes its output through strides.

A CPU tensor takes the plain version (``ref.preprocess_image_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (the count a run reads to show that
# its path went through the kernel)
LAUNCHES = 0

_DTYPES = {torch.uint8: 0, torch.float32: 1}
MAX_CHANNELS = 4  # mean and std travel to the kernel by value


def _fn():
    lib = build.load("preprocess")
    fn = lib.preprocess_image
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ll, ll, ll, ctypes.c_int, ctypes.c_void_p, ll, ll,
                       ll, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _norm(vals, default, C: int, what: str) -> torch.Tensor:
    t = default if vals is None else torch.as_tensor(vals, dtype=torch.float32)
    t = t.to("cpu", torch.float32).reshape(-1).contiguous()
    if t.numel() != C:
        raise ValueError(f"{what} needs one value per channel ({C}), got {t.numel()}")
    return t


def preprocess_image(img_chw, *, out_size=224, flip=False, mean=None, std=None, out=None):
    """Resize (bilinear, align_corners=False) the crop ``img_chw`` (C,H,W),
    uint8 or float32 at any strides, to (out_size, out_size), flipped left
    to right if ``flip``, and normalise each channel: (x - mean) / std with
    float32 ``mean``/``std`` (default: the ImageNet constants × 255).
    Returns (C, out_size, out_size) float64, written into ``out`` (any
    strides, for example one image's slot of an NHWC batch seen as CHW)
    when it is given."""
    if img_chw.dim() != 3:
        raise ValueError(f"img_chw is (C, H, W), got shape {tuple(img_chw.shape)}")
    if img_chw.dtype not in _DTYPES:
        raise ValueError(f"img_chw dtype {img_chw.dtype}: need uint8 or float32")
    C, h, w = img_chw.shape
    if not (1 <= C <= MAX_CHANNELS) or h < 1 or w < 1 or out_size < 1:
        raise ValueError(f"unsupported shape {tuple(img_chw.shape)} -> {out_size}: need "
                         f"1..{MAX_CHANNELS} channels, non-empty planes")
    mean_t = _norm(mean, ref.PREP_MEAN, C, "mean")
    std_t = _norm(std, ref.PREP_STD, C, "std")
    dev = img_chw.device
    if out is None:
        out = torch.empty((C, out_size, out_size), dtype=torch.float64, device=dev)
    elif (out.shape != (C, out_size, out_size) or out.dtype != torch.float64
          or out.device != dev):
        raise ValueError(f"out must be ({C}, {out_size}, {out_size}) float64 on {dev}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if dev.type == "cpu":
        return out.copy_(ref.preprocess_image_ref(img_chw, out_size=out_size, flip=flip,
                                                  mean=mean_t, std=std_t))
    if dev.type != "cuda":
        raise ValueError(f"preprocess_image runs on cuda or cpu, not {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(img_chw.data_ptr(), _DTYPES[img_chw.dtype], C, h, w, *img_chw.stride(),
                    int(bool(flip)), out.data_ptr(), *out.stride(), out_size, out_size,
                    mean_t.data_ptr(), std_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
