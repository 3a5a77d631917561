"""Minimal dependency-free PNG writing + volume slice grids.

Replaces the reference's torchvision save_image/make_grid usage
(trainer.py:112-126): volumes are flattened into 2D slices and tiled into a
grid (nrow=8, padding=2, min-max normalized), written as 8-bit grayscale PNG
via zlib — no torchvision/PIL dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write a 2D uint8 array as a grayscale PNG."""
    assert img.ndim == 2 and img.dtype == np.uint8
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def make_slice_grid(volumes: np.ndarray, nrow: int = 8, padding: int = 2
                    ) -> np.ndarray:
    """Volumes [B, D, H, W(, 1)] -> tiled 2D grid of all axial slices,
    min-max normalized to [0, 255] uint8 (torchvision normalize=True
    semantics)."""
    v = np.asarray(volumes, np.float32)
    if v.ndim == 5:
        v = v[..., 0]
    b, d, h, w = v.shape
    tiles = v.reshape(b * d, h, w)
    lo, hi = tiles.min(), tiles.max()
    tiles = (tiles - lo) / max(hi - lo, 1e-8)
    n = tiles.shape[0]
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding), np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        grid[y : y + h, x : x + w] = tiles[i]
    return (grid * 255.0 + 0.5).astype(np.uint8)


def save_volume_grid(path: str, volumes, nrow: int = 8, padding: int = 2
                     ) -> None:
    write_png_gray(path, make_slice_grid(np.asarray(volumes), nrow, padding))
