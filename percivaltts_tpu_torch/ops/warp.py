"""Frequency warping: linear FFT bins ↔ warped (mel) bands.

A copy of ``percivaltts_tpu/ops/warp.py`` (numpy only: the band centres,
the warp and the unwarp matrices, the mel filterbank and its
pseudo-inverse), so that the port imports nothing of the JAX package;
``tests/test_torch_imports.py`` holds it against the original. The warped
spectral representation of the PML and WORLD features (the 65-band warped
log envelope and the 33-band warped noise mask or band aperiodicity) is one
constant matrix each way, so warping an utterance is one
``(frames, bins) @ (bins, bands)`` product; the mel-spectrogram target is
one ``(bins, mels)`` product of the STFT magnitude, and Griffin-Lim starts
from its pseudo-inverse.
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def _band_centers_hz(num_bands: int, fs: int) -> np.ndarray:
    """Mel-uniform band centers spanning [0, fs/2] inclusive."""
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fs / 2.0), num_bands)
    return mel_to_hz(mels)


@functools.lru_cache(maxsize=None)
def warp_matrix(num_bands: int, dftlen: int, fs: int) -> np.ndarray:
    """(bins, bands) averaging matrix: warped = linear_bins @ W.

    Each band is a triangular kernel centered on a mel-uniform frequency,
    normalized to unit mass, with endpoints anchored at DC and Nyquist so the
    warp is invertible end-to-end. Applied to *log* magnitudes this is the
    classic warped log-envelope compression.
    """
    bins = dftlen // 2 + 1
    freqs = np.arange(bins) * fs / dftlen
    centers = _band_centers_hz(num_bands, fs)
    W = np.zeros((bins, num_bands), dtype=np.float32)
    for b in range(num_bands):
        lo = centers[b - 1] if b > 0 else centers[0] - (centers[1] - centers[0])
        hi = (
            centers[b + 1]
            if b < num_bands - 1
            else centers[-1] + (centers[-1] - centers[-2])
        )
        c = centers[b]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        w = np.maximum(0.0, np.minimum(up, down))
        s = w.sum()
        if s > 0:
            W[:, b] = w / s
    return W


@functools.lru_cache(maxsize=None)
def unwarp_matrix(num_bands: int, dftlen: int, fs: int) -> np.ndarray:
    """(bands, bins) linear-interpolation matrix: linear_bins = warped @ U.

    Each FFT bin interpolates between its two surrounding band centers —
    the pseudo-inverse of the triangular averaging for smooth spectra.
    """
    bins = dftlen // 2 + 1
    freqs = np.arange(bins) * fs / dftlen
    centers = _band_centers_hz(num_bands, fs)
    U = np.zeros((num_bands, bins), dtype=np.float32)
    j = 0
    for i, f in enumerate(freqs):
        while j < num_bands - 2 and centers[j + 1] < f:
            j += 1
        c0, c1 = centers[j], centers[j + 1]
        t = np.clip((f - c0) / max(c1 - c0, 1e-9), 0.0, 1.0)
        U[j, i] = 1.0 - t
        U[j + 1, i] = t
    return U


@functools.lru_cache(maxsize=None)
def mel_pinv(num_mels: int, dftlen: int, fs: int) -> np.ndarray:
    """(mels, bins) Moore–Penrose pseudo-inverse of the mel filterbank, for
    magnitude recovery before Griffin–Lim (negatives clipped downstream)."""
    return np.linalg.pinv(mel_weights(num_mels, dftlen, fs)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_weights(num_mels: int, dftlen: int, fs: int, fmin: float = 0.0, fmax=None) -> np.ndarray:
    """(bins, num_mels) Slaney-style triangular mel filterbank. Unlike
    ``warp_matrix`` the triangles have unit peak, not unit mass, and operate
    on magnitudes (warp first, log after)."""
    fmax = fs / 2.0 if fmax is None else fmax
    bins = dftlen // 2 + 1
    freqs = np.arange(bins) * fs / dftlen
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2))
    W = np.zeros((bins, num_mels), dtype=np.float32)
    for m in range(num_mels):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        W[:, m] = np.maximum(0.0, np.minimum(up, down))
    return W
