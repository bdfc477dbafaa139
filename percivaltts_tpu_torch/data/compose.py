"""Waveform files: the ``load_wav`` / ``save_wav`` of
``percivaltts_tpu/data/compose.py``, copied so that the port imports nothing
of the JAX package (the rest of that module, the compose stage, waits:
ROADMAP, queue 1)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[int, np.ndarray]:
    """Load a wav file as float32 in [-1, 1].

    Accepts 16/24-in-32/32-bit PCM and float32/64; anything else raises
    with the fix spelled out rather than silently mis-scaling."""
    import scipy.io.wavfile as wavfile

    fs, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype != np.float32:
        raise ValueError(
            f"{path}: unsupported wav sample format {x.dtype} — convert the "
            "corpus to 16-bit PCM (e.g. `sox in.wav -b 16 out.wav`); "
            "supported: int16, int32, float32, float64"
        )
    if x.ndim > 1:
        x = x.mean(axis=1)
    return fs, x


def save_wav(path: str, fs: int, x: np.ndarray) -> None:
    """Write ``x`` (clipped to [-1, 1]) as 16-bit PCM at ``fs``."""
    import scipy.io.wavfile as wavfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xi = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    wavfile.write(path, fs, (xi * 32767.0).astype(np.int16))
