"""Corpus normalization statistics + transforms (the port's copy of
``percivaltts_tpu/data/normalize.py``).

``normalized = (x - shift) * scale``. Stats are stored as a small ``.npz``
(``shift``, ``scale``, ``kind``) that either package reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, Tuple

import numpy as np


@dataclass
class NormStats:
    """Affine normalization stats: ``normalized = (x - shift) * scale``."""

    shift: np.ndarray  # (dim,)
    scale: np.ndarray  # (dim,)
    kind: str = "meanstd"  # "meanstd" | "minmax"

    def normalize(self, x):
        return (x - self.shift) * self.scale

    def denormalize(self, x):
        return x / self.scale + self.shift

    def save(self, path: str) -> None:
        np.savez(path, shift=self.shift, scale=self.scale, kind=self.kind)

    @classmethod
    def load(cls, path: str) -> "NormStats":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                shift=z["shift"].astype(np.float32),
                scale=z["scale"].astype(np.float32),
                kind=str(z["kind"]),
            )


def _running_moments(arrays: Iterable[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Single-pass corpus mean/var via per-file sufficient statistics."""
    s1 = s2 = None
    n = 0
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        if s1 is None:
            s1, s2 = a.sum(axis=0), (a * a).sum(axis=0)
        else:
            s1 += a.sum(axis=0)
            s2 += (a * a).sum(axis=0)
        n += a.shape[0]
    if n == 0:
        raise ValueError("no frames to compute statistics over")
    mean = s1 / n
    var = np.maximum(s2 / n - mean * mean, 0.0)
    return mean, var, n


def compute_meanstd(
    arrays: Iterable[np.ndarray],
    keep_streams: Sequence[Tuple[int, int]] = (),
    eps: float = 1e-8,
) -> NormStats:
    """Mean/std stats. ``keep_streams`` lists (start, end) column ranges left
    un-normalized (shift 0, scale 1), e.g. the bounded [0, 1] noise mask."""
    mean, var, _ = _running_moments(arrays)
    shift = mean.astype(np.float32)
    scale = (1.0 / np.maximum(np.sqrt(var), eps)).astype(np.float32)
    for a, b in keep_streams:
        shift[a:b] = 0.0
        scale[a:b] = 1.0
    return NormStats(shift=shift, scale=scale, kind="meanstd")


def compute_minmax(
    arrays: Iterable[np.ndarray],
    out_range: Tuple[float, float] = (0.01, 0.99),
    eps: float = 1e-8,
) -> NormStats:
    """Min/max stats mapping the corpus range onto ``out_range`` (the
    input-side normalization for binary label features)."""
    lo = hi = None
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        amin, amax = a.min(axis=0), a.max(axis=0)
        lo = amin if lo is None else np.minimum(lo, amin)
        hi = amax if hi is None else np.maximum(hi, amax)
    if lo is None:
        raise ValueError("no frames to compute statistics over")
    span = np.maximum(hi - lo, eps)
    r0, r1 = out_range
    # (x - lo) / span * (r1 - r0) + r0  =  (x - shift) * scale
    scale = ((r1 - r0) / span).astype(np.float32)
    shift = (lo - r0 / np.maximum(scale, eps)).astype(np.float32)
    return NormStats(shift=shift, scale=scale, kind="minmax")
