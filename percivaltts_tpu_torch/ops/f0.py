"""Batched YIN-style f0 estimation.

Counterpart of ``percivaltts_tpu/ops/f0.py`` with a leading batch axis
(signals ``(B, n)``, tracks ``(B, nf)``): the YIN algorithm (de Cheveigné &
Kawahara 2002) — difference function via FFT cross-correlation,
cumulative-mean normalization, first-trough-below-threshold lag selection
with parabolic refinement — over all frames of all rows at once. The framing
runs in ``ops/frames_cuda.py`` (on the card, TPU kernel #5's port). The JAX
module's two ``lax.scan`` fills through unvoiced regions are a running max
and a reversed running min of voiced frame indices here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from percivaltts_tpu_torch.ops.stft import frame_signal, rdiv


class F0Result(NamedTuple):
    f0: torch.Tensor  # (B, nf) continuous f0 in Hz (interpolated through unvoiced)
    vuv: torch.Tensor  # (B, nf) {0., 1.} voicing decision
    raw_f0: torch.Tensor  # (B, nf) f0 where voiced, 0 elsewhere


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, f, idx[b, f]]`` for (B, nf, L) ``x`` and (B, nf) ``idx``."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def estimate_f0(
    x: torch.Tensor,
    fs: int,
    hop: int,
    f0_min: float = 60.0,
    f0_max: float = 400.0,
    threshold: float = 0.15,
    voicing_threshold: float = 0.55,
) -> F0Result:
    """YIN f0 tracks of ``(B, n)`` signals at frame rate ``fs/hop``.

    ``threshold`` is YIN's trough-selection threshold; ``voicing_threshold``
    is the CMND value below which a frame counts as voiced (deliberately
    permissive, so that a resynthesis reads the same voicing back)."""
    tau_min = max(int(fs / f0_max), 2)
    tau_max = int(math.ceil(fs / f0_min)) + 1
    W = tau_max * 2  # integration window: two max-periods
    frame_len = W + tau_max
    dev = x.device

    frames = frame_signal(x, frame_len, hop)  # (B, nf, W + tau_max)

    # difference function d(τ) = E0 + E(τ) − 2·corr(τ) for τ ∈ [0, tau_max)
    n_fft = _next_pow2(frame_len + W)
    F_full = torch.fft.rfft(frames, n=n_fft, dim=-1)
    F_head = torch.fft.rfft(frames[..., :W], n=n_fft, dim=-1)
    corr = torch.fft.irfft(F_full * torch.conj(F_head), n=n_fft, dim=-1)[..., :tau_max]

    csum = F.pad(torch.cumsum(torch.square(frames), dim=-1), (1, 0))
    # E(τ) = Σ_{j=τ}^{τ+W-1} x², for all τ at once
    tau = torch.arange(tau_max, device=dev)
    E_tau = csum[..., tau + W] - csum[..., tau]
    E0 = E_tau[..., :1]
    d = torch.clamp(E0 + E_tau - 2.0 * corr, min=0.0)

    # cumulative-mean-normalized difference d'(τ) = d(τ)·τ / Σ_{1..τ} d
    cum = torch.cumsum(d[..., 1:], dim=-1)
    dn = torch.cat(
        [torch.ones_like(d[..., :1]), d[..., 1:] * tau[1:] / torch.clamp(cum, min=1e-12)], dim=-1
    )

    # lag selection: first trough below threshold in [tau_min, tau_max);
    # else the first trough within 0.05 of the lowest trough (not the global
    # minimum, which the normalization biases toward the subharmonic)
    valid = (tau >= tau_min) & (tau < tau_max - 1)
    left = torch.cat([dn[..., :1], dn[..., :-1]], dim=-1)
    right = torch.cat([dn[..., 1:], dn[..., -1:]], dim=-1)
    trough = (dn < left) & (dn <= right) & valid
    below = trough & (dn < threshold)
    has_below = below.any(dim=-1)
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)  # first of ties
    inf = torch.tensor(math.inf, device=dev)
    dn_tr = torch.where(trough, dn, inf)
    has_trough = trough.any(dim=-1)
    tr_min = torch.amin(dn_tr, dim=-1)
    near_min = trough & (dn <= (tr_min + 0.05)[..., None])
    first_near = torch.argmax(near_min.to(torch.uint8), dim=-1)
    global_min = torch.argmin(torch.where(valid, dn, inf), dim=-1)
    fallback = torch.where(has_trough, first_near, global_min)
    tau_star = torch.where(has_below, first_below, fallback)

    # sub-period rescue: jump to the trough near m/(m−1)·τ* (m = 3, 4) iff it
    # is markedly deeper (a formant on harmonic m·k gives a genuine trough at
    # (m−1)·T0/m, read as m/(m−1)·f0)
    for ratio in (1.5, 4.0 / 3.0):
        d_star = _take(dn, tau_star)
        target = ratio * tau_star.to(torch.float32)
        tol = torch.clamp(0.06 * target, min=2.0)
        win = trough & (torch.abs(tau.to(torch.float32) - target[..., None]) <= tol[..., None])
        cand_dn_all = torch.where(win, dn, inf)
        cand_dn = torch.amin(cand_dn_all, dim=-1)
        cand_ix = torch.argmin(cand_dn_all, dim=-1)
        jump = torch.isfinite(cand_dn) & (cand_dn < 0.8 * d_star) & (d_star > 0.02)
        tau_star = torch.where(jump, cand_ix, tau_star)

    # parabolic interpolation around the chosen lag
    i = torch.clamp(tau_star, 1, tau_max - 2)
    dm, d0, dp = _take(dn, i - 1), _take(dn, i), _take(dn, i + 1)
    denom = dm - 2.0 * d0 + dp
    delta = torch.where(
        torch.abs(denom) > 1e-12,
        0.5 * (dm - dp) / torch.where(denom == 0, 1.0, denom),
        0.0,
    )
    delta = torch.clamp(delta, -0.5, 0.5)
    tau_refined = i.to(torch.float32) + delta

    # voicing: trough quality + minimum energy, median-filtered like f0
    energy = E0[..., 0]
    voiced = (d0 < voicing_threshold) & (
        energy > 1e-6 * torch.clamp(torch.amax(energy, dim=-1, keepdim=True), min=1e-20)
    )
    voiced = _median5(voiced.to(torch.float32)) > 0.5
    f0_frame = rdiv(fs, torch.clamp(tau_refined, min=1.0))
    f0_frame = torch.clamp(f0_frame, f0_min, f0_max)
    # octave snap against the local 11-frame median, then clip and a 5-frame
    # median (the standard YIN post-process)
    med = _median_k(f0_frame, 11)
    is_half = torch.abs(2.0 * f0_frame - med) < 0.25 * med
    is_dbl = torch.abs(0.5 * f0_frame - med) < 0.25 * med
    f0_frame = torch.where(is_half, 2.0 * f0_frame, torch.where(is_dbl, 0.5 * f0_frame, f0_frame))
    f0_frame = torch.clamp(f0_frame, f0_min, f0_max)
    f0_frame = _median5(f0_frame)
    raw = torch.where(voiced, f0_frame, 0.0)

    f0_cont = _interp_through_unvoiced(raw, voiced)
    return F0Result(f0=f0_cont, vuv=voiced.to(torch.float32), raw_f0=raw)


def _median_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-tap median (k odd) along the last axis of (B, nf) tracks,
    edge-replicated, so tracks shorter than the filter still work."""
    r = k // 2
    nf = x.shape[-1]
    idx = torch.clamp(
        torch.arange(nf, device=x.device)[:, None] + torch.arange(-r, r + 1, device=x.device),
        0, nf - 1,
    )  # (nf, k)
    return torch.median(x[..., idx], dim=-1).values


def _median5(x: torch.Tensor) -> torch.Tensor:
    """5-tap median along the last axis (edge-replicated)."""
    return _median_k(x, 5)


def _interp_through_unvoiced(raw: torch.Tensor, voiced: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of f0 through unvoiced gaps, constant at the
    edges (100 Hz in a row with no voiced frame). The nearest voiced frame
    before each frame is a running max of voiced indices, the nearest after
    a reversed running min."""
    nf = raw.shape[-1]
    ar = torch.arange(nf, device=raw.device)
    fwd = torch.cummax(torch.where(voiced, ar, -1), dim=-1).values
    bwd = torch.cummin(torch.where(voiced, ar, nf).flip(-1), dim=-1).values.flip(-1)
    have_f, have_b = fwd >= 0, bwd < nf
    fv = torch.where(have_f, torch.gather(raw, -1, torch.clamp(fwd, min=0)), 0.0)
    bv = torch.where(have_b, torch.gather(raw, -1, torch.clamp(bwd, max=nf - 1)), 0.0)
    idx, fp, bp = ar.to(torch.float32), fwd.to(torch.float32), bwd.to(torch.float32)
    wf = torch.where(have_f & have_b, (bp - idx) / torch.clamp(bp - fp, min=1.0), 0.0)
    out = torch.where(
        have_f & have_b,
        wf * fv + (1.0 - wf) * bv,
        torch.where(have_f, fv, torch.where(have_b, bv, 100.0)),
    )
    return torch.where(voiced, raw, out)
