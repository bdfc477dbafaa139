"""Binary float32 feature-file I/O (the port's copy of
``percivaltts_tpu/utils/fileio.py``, numpy only).

Merlin-style headerless files: raw little-endian float32, row-major
``(frames, dim)``; byte for byte what the JAX package writes and reads.
"""

from __future__ import annotations

import os

import numpy as np


def load_binary_file(path: str, dim: int, dtype=np.float32) -> np.ndarray:
    """Load a headerless binary feature file as ``(frames, dim)``."""
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    data = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))
    if data.size % dim != 0:
        raise ValueError(f"{path}: size {data.size} is not a multiple of dim {dim}")
    return data.astype(dtype, copy=False).reshape(-1, dim)


def save_binary_file(path: str, arr: np.ndarray, dtype=np.float32) -> None:
    """Save ``(frames, dim)`` float features as a headerless binary file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.ascontiguousarray(arr, dtype=np.dtype(dtype).newbyteorder("<")).tofile(path)
