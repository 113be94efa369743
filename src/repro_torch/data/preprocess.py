# Copied from src/repro/data/preprocess.py; only the repro. imports are rewritten.
"""Image pre-processing ops (OffloadPrep's compute): decode → random crop →
flip → bilinear resize → normalize.

Numpy reference implementations (the offloaded stub runs on storage-node
CPUs — numpy IS the production path there); ``kernels/preprocess`` provides
the fused TPU Pallas variant used when preprocessing runs on the training
host itself, with this module as its oracle.

Images are stored in a deterministic synthetic corpus (no dataset downloads
offline): raw RGB u8 with a tiny header, same size distribution as the
OpenImages subset the paper uses.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_HDR = struct.Struct("<HHB")  # h, w, c


def encode_image(arr: np.ndarray) -> bytes:
    h, w, c = arr.shape
    return _HDR.pack(h, w, c) + arr.astype(np.uint8).tobytes()


def decode_image(buf: bytes) -> np.ndarray:
    h, w, c = _HDR.unpack_from(buf, 0)
    return np.frombuffer(buf, np.uint8, h * w * c, _HDR.size).reshape(h, w, c)


def synthetic_image(seed: int, *, min_side: int = 64, max_side: int = 512) -> np.ndarray:
    rng = np.random.RandomState(seed)
    h = int(rng.randint(min_side, max_side + 1))
    w = int(rng.randint(min_side, max_side + 1))
    # cheap structured content (gradients + blocks), not pure noise
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy[..., None] * 3 + xx[..., None] * 5) % 256
    noise = rng.randint(0, 64, (h, w, 3))
    return ((base + noise) % 256).astype(np.uint8)


def random_crop_params(rng: np.random.RandomState, h: int, w: int,
                       scale=(0.35, 1.0)) -> Tuple[int, int, int, int]:
    area = h * w
    for _ in range(4):
        target = rng.uniform(*scale) * area
        ar = rng.uniform(3 / 4, 4 / 3)
        ch = int(round(np.sqrt(target / ar)))
        cw = int(round(np.sqrt(target * ar)))
        if ch <= h and cw <= w:
            y = int(rng.randint(0, h - ch + 1))
            x = int(rng.randint(0, w - cw + 1))
            return y, x, ch, cw
    side = min(h, w)
    return (h - side) // 2, (w - side) // 2, side, side


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Align-corners=False bilinear, f32."""
    h, w, c = img.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def preprocess_image(buf: bytes, seed: int, out: int = 224) -> np.ndarray:
    """decode → random resized crop → random hflip → normalize. (H,W,C) f32."""
    img = decode_image(buf)
    rng = np.random.RandomState(seed)
    y, x, ch, cw = random_crop_params(rng, img.shape[0], img.shape[1])
    crop = img[y : y + ch, x : x + cw]
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    r = bilinear_resize(crop, out, out)
    return (r - _MEAN) / _STD
