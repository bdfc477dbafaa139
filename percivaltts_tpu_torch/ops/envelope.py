"""Cepstral and true-envelope spectral envelopes, batched.

Counterpart of ``percivaltts_tpu/ops/envelope.py`` with a leading batch
axis: log magnitudes ``(B, nf, dftlen//2 + 1)``, f0 ``(B, nf)``. The real
cepstrum of each frame is liftered below its pitch period and transformed
back (``torch.fft``); the true envelope (Röbel & Rodet 2005) repeats that on
``max(log|X|, env)``. PML's ``envelope="te"`` analysis reads ``env_te`` on
every frame.
"""

from __future__ import annotations

from typing import Tuple

import torch

from percivaltts_tpu_torch.ops.stft import rdiv


def spectral_envelope(
    log_mag: torch.Tensor,
    f0: torch.Tensor,
    fs: int,
    dftlen: int,
    iterations: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smooth log-amplitude envelopes of ``log_mag`` ``(B, nf, bins)``:
    ``(env, env_te)``, the cepstrally smoothed envelope and its
    ``iterations``-fold true-envelope refinement.

    The lifter keeps quefrencies q with min(q, dftlen − q) ≤ fs / (1.3·f0)
    samples (f0 clamped at 1 Hz). That comparison is a step at an integer
    quefrency, so the cutoff is rounded as JAX rounds it: 1.3·f0 first,
    then one correctly rounded division."""
    bins = log_mag.shape[-1]
    if bins != dftlen // 2 + 1:
        raise ValueError(f"log_mag has {bins} bins, dftlen {dftlen} needs {dftlen // 2 + 1}")
    cutoff = rdiv(float(fs), 1.3 * torch.clamp(f0, min=1.0))  # (B, nf) samples
    q = torch.arange(dftlen, dtype=torch.float32, device=log_mag.device)
    qq = torch.minimum(q, dftlen - q)
    lifter = (qq <= cutoff[..., None]).to(log_mag.dtype)  # (B, nf, dftlen)

    def smooth(lm):
        # the irfft of the half log spectrum is the real, even cepstrum
        cep = torch.fft.irfft(lm, n=dftlen, dim=-1) * lifter
        return torch.fft.rfft(cep, n=dftlen, dim=-1).real[..., :bins]

    env = smooth(log_mag)
    env_te = env
    for _ in range(iterations):
        env_te = smooth(torch.maximum(log_mag, env_te))
    return env, env_te
