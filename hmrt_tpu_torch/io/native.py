"""A square raw-f32 heightmap file read tile by tile.

Counterpart of `RawTileMap` in `hmrt_tpu/io/native/__init__.py`, as its
numpy memmap form (the JAX class falls back to exactly this without its C
library): maps larger than host memory stream into the tiled renderer
without being read whole.
"""

from __future__ import annotations

import numpy as np


class RawTileMap:
    """mmap'd square raw-f32 heightmap with edge-clamped tile extraction."""

    def __init__(self, path: str):
        mm = np.memmap(path, dtype=np.float32, mode="r")
        n = int(round(len(mm) ** 0.5))
        if n * n != len(mm):
            raise ValueError(f"{path}: raw f32 file is not square")
        self._mm = mm.reshape(n, n)
        self.side = n

    def tile(self, y0: int, x0: int, th: int, tw: int) -> np.ndarray:
        """Samples [y0, y0+th) x [x0, x0+tw), indices clamped to the map."""
        ys = np.clip(np.arange(y0, y0 + th), 0, self.side - 1)
        xs = np.clip(np.arange(x0, x0 + tw), 0, self.side - 1)
        return np.asarray(self._mm[np.ix_(ys, xs)], np.float32)

    def close(self):
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
