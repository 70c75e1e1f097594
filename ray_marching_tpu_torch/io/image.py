"""Dependency-free PNG writing (numpy + zlib), counterpart of
``ray_marching_tpu/io/image.py::write_png``."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def _to_uint8(image: np.ndarray) -> np.ndarray:
    if image.dtype != np.uint8:
        image = (np.clip(np.nan_to_num(image, nan=0.0), 0.0, 1.0) * 255.0
                 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = image[:, :, None]
    return image


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """Encode an (H, W, {1,3,4}) uint8 or float [0, 1] array as PNG bytes
    (NaN maps to black)."""
    image = _to_uint8(np.asarray(image))
    h, w, c = image.shape
    colour_type = {1: 0, 3: 2, 4: 6}[c]
    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    filt = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per scanline
    filt[:, 1:] = image.reshape(h, w * c)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(filt.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path, image) -> Path:
    """Write an image ((H, W, C) or (N, H, W, C); a tensor on any device or
    a numpy array) to PNG. A leading camera axis is averaged away."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.ndim == 4:
        was_uint8 = image.dtype == np.uint8
        image = image.mean(axis=0)
        if was_uint8:
            image = (image + 0.5).astype(np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(image))
    return path
