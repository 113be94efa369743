"""Wrappers of the Hopper preprocess kernels (``csrc/preprocess.cu``).

They replace the Pallas banded-matmul kernel ``src/repro/kernels/preprocess.py``
(``_prep_kernel`` / ``preprocess_plane``) and the JAX wrapper's resize
operators (``src/repro/kernels/ops.py`` ``preprocess_image``): the kernels
gather four pixels per output element in float64, as the storage node's
numpy path does. ``preprocess_image`` takes one image at any strides;
``preprocess_batch`` takes every crop of a minibatch's share, packed by
``pack_crops`` into one buffer, in one launch.

A CPU tensor takes the plain version (``ref.preprocess_image_ref``,
``ref.preprocess_batch_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.uint8: 0, torch.float32: 1}
MAX_CHANNELS = 4  # mean and std travel to the kernel by value
MAX_BATCH_OUT = 2048  # the batch kernel's output side (its taps in shared memory)
MAX_BATCH_IMAGES = 65535  # the batch kernel's grid.y
# a row of preprocess_batch's table: the crop's byte offset in the packed
# buffer, its height, width and channels, flip (0/1), its slot in the batch
DESC_COLUMNS = ("offset", "h", "w", "C", "flip", "slot")

# each entry's C signature, the stream last
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = {
    "preprocess_image": [_P, _I, _I, _I, _I, _LL, _LL, _LL, _I, _P, _LL, _LL, _LL, _I, _I,
                         _P, _P, _P],
    "preprocess_batch": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
}


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
    build.launch("preprocess", "preprocess_image", _ARGTYPES["preprocess_image"], dev,
                 img_chw.data_ptr(), _DTYPES[img_chw.dtype], C, h, w, *img_chw.stride(),
                 int(bool(flip)), out.data_ptr(), *out.stride(), out_size, out_size,
                 mean_t.data_ptr(), std_t.data_ptr())
    return out


def pack_crops(crops: Sequence[np.ndarray], flips: Sequence[bool], slots: Sequence[int],
               device) -> tuple:
    """The host side of ``preprocess_batch``: copies the HWC uint8 crops
    (numpy arrays, views allowed) back to back into one host buffer, pinned
    when ``device`` is a CUDA device, and sends it there with one
    asynchronous copy. Returns (packed, desc): the uint8 buffer on
    ``device`` and the (N, 6) int64 table on the host (``DESC_COLUMNS``),
    pinned too for a CUDA device.

    The buffer comes from PyTorch's pinned allocator, which hands a block
    out again only after the copy that read it has run, so a producer
    thread that packs the next minibatch while this one's copy is in
    flight cannot overwrite it."""
    device = torch.device(device)
    if not (len(crops) == len(flips) == len(slots)):
        raise ValueError("one flip and one slot per crop")
    for c in crops:
        if c.dtype != np.uint8 or c.ndim != 3:
            raise ValueError(f"crops are (h, w, C) uint8, got {c.shape} {c.dtype}")
    sizes = [c.size for c in crops]
    offsets = np.cumsum([0, *sizes])
    host = torch.empty(int(offsets[-1]), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    for c, a, b in zip(crops, offsets[:-1], offsets[1:]):
        buf[a:b].reshape(c.shape)[...] = c
    desc = torch.tensor([[int(a), *c.shape, int(bool(f)), int(s)]
                         for c, a, f, s in zip(crops, offsets[:-1], flips, slots)],
                        dtype=torch.int64).reshape(len(crops), len(DESC_COLUMNS))
    if device.type == "cuda":  # preprocess_batch copies it without waiting
        desc = desc.pin_memory()
    return host.to(device, non_blocking=True), desc


def _check_desc(desc: torch.Tensor, packed_bytes: int, n: int, C: int) -> None:
    if (desc.device.type != "cpu" or desc.dtype != torch.int64 or desc.dim() != 2
            or desc.shape[1] != len(DESC_COLUMNS)):
        raise ValueError(f"desc is an (N, {len(DESC_COLUMNS)}) int64 table on the host, got "
                         f"{tuple(desc.shape)} {desc.dtype} on {desc.device}")
    off, h, w, c, flip, slot = desc.unbind(1)
    bad = ((off < 0) | (h < 1) | (w < 1) | (c != C) | (off + h * w * c > packed_bytes)
           | ((flip != 0) & (flip != 1)) | (slot < 0) | (slot >= n))
    if bool(bad.any()):
        raise ValueError(f"desc row {int(bad.nonzero()[0, 0])} is out of range for "
                         f"{packed_bytes} packed bytes, {n} slots of {C} channels")
    if slot.unique().numel() != slot.numel():
        raise ValueError("desc gives two crops one slot")


def preprocess_batch(packed, desc, out, *, mean=None, std=None):
    """Resize, flip and normalise every crop of ``packed`` into its slot of
    ``out`` in one launch: image by image what ``preprocess_image`` gives
    for the crop seen as CHW. ``packed`` is a 1-D uint8 buffer of HWC crops
    and ``desc`` its (N, 6) int64 table on the host, as ``pack_crops``
    makes them; ``out`` is a contiguous (n, S, S, C) float64 batch on
    ``packed``'s device, of which the N slots named in ``desc`` are written.
    ``mean``/``std`` as ``preprocess_image``. Returns ``out``."""
    if packed.dim() != 1 or packed.dtype != torch.uint8:
        raise ValueError(f"packed is a 1-D uint8 buffer, got {tuple(packed.shape)} "
                         f"{packed.dtype}")
    dev = packed.device
    if (out.dim() != 4 or out.dtype != torch.float64 or out.device != dev
            or out.shape[1] != out.shape[2] or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous (n, S, S, C) float64 batch on {dev}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    n, S, _, C = out.shape
    if not (1 <= C <= MAX_CHANNELS) or S < 1:
        raise ValueError(f"unsupported batch {tuple(out.shape)}: need 1..{MAX_CHANNELS} "
                         f"channels, non-empty images")
    _check_desc(desc, packed.numel(), n, C)
    mean_t = _norm(mean, ref.PREP_MEAN, C, "mean")
    std_t = _norm(std, ref.PREP_STD, C, "std")
    if desc.shape[0] == 0:
        return out
    if dev.type == "cpu":
        return ref.preprocess_batch_ref(packed, desc, out, mean=mean_t, std=std_t)
    if dev.type != "cuda":
        raise ValueError(f"preprocess_batch runs on cuda or cpu, not {dev}")
    if S > MAX_BATCH_OUT or desc.shape[0] > MAX_BATCH_IMAGES:
        raise ValueError(f"preprocess_batch takes at most {MAX_BATCH_IMAGES} images of side "
                         f"at most {MAX_BATCH_OUT}, got {desc.shape[0]} of {S}")
    desc_dev = desc.to(dev, non_blocking=True)
    build.launch("preprocess", "preprocess_batch", _ARGTYPES["preprocess_batch"], dev,
                 packed.data_ptr(), desc_dev.data_ptr(), desc.shape[0], out.data_ptr(), C, S,
                 S, mean_t.data_ptr(), std_t.data_ptr())
    return out
