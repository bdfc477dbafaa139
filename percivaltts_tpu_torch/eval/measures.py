"""Objective measures: MCD, F0 RMSE, VUV error, global variance and the
modulation spectrum (counterpart of ``percivaltts_tpu/eval/measures.py``).

Plain torch functions on tensors (numpy arrays are taken too): they run on
the device of their inputs. ``per_frame_mcd_np`` stays numpy, for host-side
per-utterance aggregation.

Definitions:
* MCD (dB) = (10/ln 10) · sqrt(2 · Σ_{d≥1} (c1_d − c2_d)²), mean over frames,
  on (mel-)cepstral coefficients, c0 (energy) excluded.
* F0 RMSE over frames voiced in BOTH tracks; Hz or cents
  (1200·log2(f1/f2)).
* VUV error %: fraction of frames whose voicing decisions disagree.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_MCD_K = 10.0 / math.log(10.0) * math.sqrt(2.0)


def _t(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def log_spec_to_cepstra(logspec, order: Optional[int] = None) -> torch.Tensor:
    """Log-amplitude spectra (…, F) → cepstra (…, order) through an
    orthonormal DCT-II over the (warped) frequency axis: one (F, order)
    product a frame. ``order`` is clamped to F (a larger basis would alias
    low-order energy into duplicated columns)."""
    x = _t(logspec)
    F = x.shape[-1]
    order = F if order is None else min(order, F)
    n = torch.arange(F, dtype=torch.float32, device=x.device)
    k = torch.arange(order, dtype=torch.float32, device=x.device)
    basis = torch.cos(math.pi * (n[:, None] + 0.5) * k[None, :] / F)  # (F, order)
    scale = torch.full((order,), math.sqrt(2.0 / F), device=x.device)
    scale[0] = math.sqrt(1.0 / F)
    return torch.matmul(x, basis * scale[None, :])


def per_frame_mcd_np(cep1: np.ndarray, cep2: np.ndarray, exclude_c0: bool = True) -> np.ndarray:
    """Per-frame MCD in dB, in numpy (host-side aggregation; same formula
    as ``mcd``)."""
    d = np.asarray(cep1) - np.asarray(cep2)
    if exclude_c0:
        d = d[..., 1:]
    return _MCD_K * np.sqrt(np.sum(d * d, axis=-1))


def _masked_mean(x: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = _t(mask, x.dtype).to(x.device)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def mcd(cep1, cep2, mask=None, exclude_c0: bool = True) -> torch.Tensor:
    """Mel-cepstral distortion in dB, mean over (valid) frames.
    cep1/cep2: (..., T, D) cepstra; mask: (..., T) validity."""
    d = _t(cep1) - _t(cep2)
    if exclude_c0:
        d = d[..., 1:]
    return _masked_mean(_MCD_K * torch.sqrt(d.square().sum(dim=-1)), mask)


def _both_voiced(v1, v2, mask) -> torch.Tensor:
    both = (_t(v1) > 0.5) & (_t(v2) > 0.5)
    if mask is not None:
        both = both & (_t(mask) > 0.5)
    return both.float()


def f0_rmse(f0_1, f0_2, vuv_1, vuv_2, mask=None) -> torch.Tensor:
    """F0 RMSE in Hz over frames voiced in both tracks."""
    w = _both_voiced(vuv_1, vuv_2, mask)
    se = (_t(f0_1) - _t(f0_2)).square() * w
    return torch.sqrt(se.sum() / torch.clamp(w.sum(), min=1.0))


def f0_rmse_cents(f0_1, f0_2, vuv_1, vuv_2, mask=None, eps: float = 1e-6) -> torch.Tensor:
    """F0 RMSE in cents (1200·log2 ratio) over frames voiced in both."""
    w = _both_voiced(vuv_1, vuv_2, mask)
    cents = 1200.0 * torch.log2(torch.clamp(_t(f0_1), min=eps) / torch.clamp(_t(f0_2), min=eps))
    return torch.sqrt((cents.square() * w).sum() / torch.clamp(w.sum(), min=1.0))


def vuv_error(vuv_1, vuv_2, mask=None) -> torch.Tensor:
    """Voiced/unvoiced decision disagreement, in percent."""
    diff = ((_t(vuv_1) > 0.5) != (_t(vuv_2) > 0.5)).float()
    return 100.0 * _masked_mean(diff, mask)


def global_variance(cep, mask=None) -> torch.Tensor:
    """Per-dimension variance of cepstra over (valid) frames, (D,). cep:
    (T, D) or (B, T, D); mask: (T,) / (B, T). With a batch, frames pool
    across it (corpus-level GV)."""
    cep = _t(cep)
    flat = cep.reshape(-1, cep.shape[-1])
    if mask is None:
        w = torch.ones(flat.shape[0], dtype=torch.float32, device=flat.device)
    else:
        w = _t(mask, torch.float32).to(flat.device).reshape(-1)
    tot = torch.clamp(w.sum(), min=1.0)
    mean = (flat * w[:, None]).sum(dim=0) / tot
    return ((flat - mean[None, :]).square() * w[:, None]).sum(dim=0) / tot


def global_variance_ratio(cep_pred, cep_ref, mask_pred=None, mask_ref=None,
                          exclude_c0: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """Geometric mean over dimensions of GV(pred)/GV(ref): 1.0 = natural
    spectral dispersion, < 1 = over-smoothed; c0 excluded by default."""
    gv_p = global_variance(cep_pred, mask_pred)
    gv_r = global_variance(cep_ref, mask_ref)
    if exclude_c0:
        gv_p, gv_r = gv_p[1:], gv_r[1:]
    logr = torch.log(torch.clamp(gv_p, min=eps)) - torch.log(torch.clamp(gv_r, min=eps))
    return torch.exp(logr.mean())


def _hanning(n: int, device) -> torch.Tensor:
    """numpy's ``hanning`` (symmetric, zero at both ends)."""
    if n == 1:
        return torch.ones(1, device=device)
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / (n - 1))


def modulation_spectrum(feats, mask=None, seg: int = 128) -> torch.Tensor:
    """Mean power spectrum over time of each feature trajectory,
    (seg//2+1, D). feats: (T, D) or (B, T, D); mask: (T,) / (B, T).
    Trajectories are mean-removed per utterance over valid frames;
    Hann-windowed segments of ``seg`` frames (hop seg/2) are rFFT'd over
    time, and segment power spectra average with per-segment validity
    weights."""
    feats = _t(feats, torch.float32)
    if feats.ndim == 2:
        feats = feats[None]
        mask = None if mask is None else _t(mask)[None]
    B, T, D = feats.shape
    dev = feats.device
    w = (torch.ones((B, T), dtype=torch.float32, device=dev) if mask is None
         else _t(mask, torch.float32).to(dev))
    tot = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    mu = (feats * w[..., None]).sum(dim=1, keepdim=True) / tot[..., None]
    xc = (feats - mu) * w[..., None]

    hop = seg // 2
    nseg = max((max(T, seg) - seg) // hop + 1, 1)
    pad = (nseg - 1) * hop + seg - T
    if pad > 0:
        xc = torch.nn.functional.pad(xc, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    idx = torch.arange(seg, device=dev)[None, :] + hop * torch.arange(nseg, device=dev)[:, None]
    segs = xc[:, idx, :]  # (B, nseg, seg, D)
    win = _hanning(seg, dev)
    P = torch.fft.rfft(segs * win[None, None, :, None], dim=2).abs().square()
    wseg = w[:, idx].mean(dim=2)  # (B, nseg) validity fraction
    den = torch.clamp(wseg.sum(), min=1e-6)
    return (P * wseg[..., None, None]).sum(dim=(0, 1)) / den


def modulation_spectrum_ratio(
    feats_pred, feats_ref, mask_pred=None, mask_ref=None, frame_rate: float = 200.0,
    bands: tuple = ((1.0, 4.0), (4.0, 10.0), (10.0, 25.0), (25.0, 50.0)),
    seg: int = 128, exclude_c0: bool = True, eps: float = 1e-12,
) -> torch.Tensor:
    """Per modulation band, the geometric mean over (bins in band, dims) of
    MS(pred)/MS(ref): 1.0 = natural temporal dispersion there, < 1 =
    temporally over-smoothed. frame_rate: frames per second. Returns
    (len(bands),); c0 excluded by default."""
    if exclude_c0:
        feats_pred = _t(feats_pred)[..., 1:]
        feats_ref = _t(feats_ref)[..., 1:]
    ms_p = modulation_spectrum(feats_pred, mask_pred, seg=seg)
    ms_r = modulation_spectrum(feats_ref, mask_ref, seg=seg)
    freqs = torch.fft.rfftfreq(seg, d=1.0 / frame_rate, device=ms_p.device)
    logr = torch.log(torch.clamp(ms_p, min=eps)) - torch.log(torch.clamp(ms_r, min=eps))
    out = []
    for lo, hi in bands:
        sel = ((freqs >= lo) & (freqs < hi)).float()[:, None]
        out.append(torch.exp((logr * sel).sum() / torch.clamp(sel.sum() * logr.shape[1], min=1.0)))
    return torch.stack(out)
