"""Image output helpers (reference analogue: the demo's tensor->PIL PNG path,
/root/reference/render_sample.py:129-136)."""

from __future__ import annotations

import numpy as np


def to_uint8(image) -> np.ndarray:
    """(H, W, C) float image in [0, 1] -> uint8, clipped."""
    arr = np.asarray(image)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W, C) image -> in-memory PNG bytes (pure stdlib zlib;
    serves the web viewer without touching disk or PIL)."""
    import struct
    import zlib

    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(
        b"\x00" + np.ascontiguousarray(arr[i]).tobytes() for i in range(h)
    )

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(image, path: str) -> None:
    """Save a float (H, W, C) image to a PNG file.

    Prefers the native C encoder (mojosplat_jax/native); falls back to PIL.
    """
    arr = to_uint8(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    from ..native import get_native

    native = get_native()
    if native is not None and arr.shape[2] in (1, 3, 4):
        h, w, c = arr.shape
        native.write_png(
            path, h, w, c, np.ascontiguousarray(arr).tobytes()
        )
        return
    from PIL import Image

    Image.fromarray(arr.squeeze()).save(path)
