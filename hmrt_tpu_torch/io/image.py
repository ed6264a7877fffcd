"""Dependency-free PNG writer (numpy and the standard library only).

A copy of `encode_png`/`write_png` of `hmrt_tpu/io/image.py`."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W, 3) float [0,1] or uint8, or (H, W) grayscale, as PNG
    bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        img = img[:, :, None]
    elif img.shape[2] == 1:
        color_type = 0
    elif img.shape[2] == 2:  # gray + alpha
        color_type = 4
    elif img.shape[2] == 3:
        color_type = 2
    elif img.shape[2] == 4:
        color_type = 6
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float [0,1] or uint8, or (H, W) grayscale, as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
