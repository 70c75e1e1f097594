"""Dependency-free PNG and APNG writing (numpy + zlib), counterpart of
``ray_marching_tpu/io/image.py`` (``encode_png``, ``write_apng``,
``write_png``)."""

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


def write_apng(path, frames, fps: float = 30.0, num_plays: int = 0) -> Path:
    """Write an animated PNG from an iterable of (H, W, {1,3,4}) frames
    (uint8 or float [0, 1]; all of one shape). ``num_plays=0`` loops
    forever. The first frame doubles as the still image."""
    frames = [_to_uint8(np.asarray(f)) for f in frames]
    if not frames:
        raise ValueError("write_apng needs at least one frame")
    h, w, c = frames[0].shape
    for f in frames:
        if f.shape != (h, w, c):
            raise ValueError(f"frame shape {f.shape} != {(h, w, c)}")
    colour_type = {1: 0, 3: 2, 4: 6}[c]
    delay_den = 1000
    delay_num = max(1, round(delay_den / fps))

    def scanlines(img):
        filt = np.zeros((h, 1 + w * c), np.uint8)
        filt[:, 1:] = img.reshape(h, w * c)
        return zlib.compress(filt.tobytes(), 6)

    out = [
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)),
        _chunk(b"acTL", struct.pack(">II", len(frames), num_plays)),
    ]
    seq = 0
    for i, f in enumerate(frames):
        out.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0)))
        seq += 1
        data = scanlines(f)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"".join(out))
    return path


def write_png(path, image) -> Path:
    """Write an image ((H, W, C) or (N, H, W, C); a tensor on any device or
    a numpy array) to PNG. A leading camera axis is averaged away."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.ndim == 4 and image.shape[0] == 1:
        image = image[0]  # the mean of one camera, without a pass over it
    elif image.ndim == 4:
        was_uint8 = image.dtype == np.uint8
        image = image.mean(axis=0)
        if was_uint8:
            image = (image + 0.5).astype(np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(image))
    return path
