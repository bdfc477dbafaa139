"""Framing, windows, STFT / inverse STFT (overlap-add), batched.

Counterpart of ``percivaltts_tpu/ops/stft.py`` with a leading batch axis:
signals are ``(B, n)``, frames ``(B, nf, fl)``, spectra ``(B, nf, bins)``.
The framing and the overlap-add are ``ops/frames_cuda.py``: on the card the
hand-written kernels (TPU kernels #5 and #6), on the CPU their plain twins,
the shifted-view scheme of the JAX module. The FFTs, which the JAX package
leaves to XLA's ``jnp.fft``, go to ``torch.fft``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from percivaltts_tpu_torch.ops import frames_cuda


def hann_window(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (matches scipy.signal.get_window('hann', n))."""
    n = torch.arange(length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / length)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as one correctly rounded division, as JAX and numpy
    compute it (torch computes a Python number over a tensor as the number
    times the tensor's reciprocal: two roundings)."""
    return torch.full_like(t, num) / t


def num_frames(num_samples: int, frame_length: int, hop: int) -> int:
    """Frames for a center-padded analysis: one frame per hop covering the
    whole signal."""
    return -(-num_samples // hop)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, pad: bool = True) -> torch.Tensor:
    """``(B, n)`` → ``(B, ceil(n / hop), frame_length)`` overlapping frames,
    frame i centred on sample i·hop (zeros outside the signal). With
    ``pad=False``: the ``max(1 + (n − frame_length) // hop, 0)`` frames that
    lie wholly inside the signal, frame i starting at sample i·hop, cut by
    plain slicing as the JAX package cuts them (no kernel)."""
    if not pad:
        B, n = x.shape
        nf = max(1 + (n - frame_length) // hop, 0)
        if nf == 0:
            return x.new_zeros((B, 0, frame_length))
        return x.unfold(-1, frame_length, hop)[:, :nf].contiguous()
    return frames_cuda.frame_window(x, frame_length, hop)


def stft(
    x: torch.Tensor,
    frame_length: int,
    hop: int,
    dftlen: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Short-time Fourier transform, ``(B, n)`` → ``(B, nf, dftlen//2 + 1)``
    complex. The window multiply is fused into the framing."""
    dftlen = dftlen or frame_length
    if window is None:
        window = hann_window(frame_length, x.dtype, x.device)
    frames = frames_cuda.frame_window(x, frame_length, hop, window)
    return torch.fft.rfft(frames, n=dftlen, dim=-1)


def overlap_add(frames: torch.Tensor, hop: int, out_length: int) -> torch.Tensor:
    """Overlap-add synthesis: ``(B, nf, fl)`` → ``(B, out_length)``, frame i
    added centred on sample i·hop (the inverse of ``frame_signal``'s
    centring)."""
    return frames_cuda.overlap_add(frames, hop, out_length)


def istft(
    spec: torch.Tensor,
    frame_length: int,
    hop: int,
    out_length: int,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add and COLA normalization,
    ``(B, nf, bins)`` → ``(B, out_length)``. Two overlap-adds, as the JAX
    code: the windowed frames, and the window² normaliser (one row, shared
    by the batch, read through a stride-0 view: no copy)."""
    if window is None:
        window = hann_window(frame_length, device=spec.device)
    frames = torch.fft.irfft(spec, dim=-1)[..., :frame_length] * window
    y = overlap_add(frames, hop, out_length)
    nf = spec.shape[-2]
    wsq = overlap_add((window * window).expand(1, nf, frame_length), hop, out_length)
    return y / torch.clamp(wsq, min=1e-8)
