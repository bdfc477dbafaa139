"""F0-adaptive spectral-envelope estimation (CheapTrick-style), batched.

Counterpart of ``percivaltts_tpu/ops/cheaptrick.py`` with a leading batch
axis: signals ``(B, n)``, per-frame tracks ``(B, nf)``, spectra
``(B, nf, bins)``. The published CheapTrick algorithm (M. Morise,
Speech Communication 67, 2015): an f0-adaptive Hanning window of 3·T0, the
power spectrum with DC mirroring below f0, rectangular smoothing of width
2·f0/3, then log and quefrency liftering. The framing runs in
``ops/frames_cuda.py`` (on the card, TPU kernel #5's port).

Output convention: **log harmonic amplitude** — for a harmonic of amplitude
``a_k`` the envelope reads ``log a_k``, and for stationary noise of
per-sample standard deviation σ it reads ``log(σ · sqrt(f0 · CAL · dftlen /
fs))``; the PML synthesis inverts exactly these two formulas.
"""

from __future__ import annotations

import math

import torch

from percivaltts_tpu_torch.ops.morph import shift_frames
from percivaltts_tpu_torch.ops.stft import frame_signal, rdiv

# Calibration constant of the estimator chain for the Hanning(3·T0) window
# (the JAX package's, measured there on synthetic harmonic signals across
# f0 ∈ [80, 400] Hz; window-shape dependent only).
CAL = 0.004057

# f0 used for unvoiced frames (wide analysis bands, low estimator variance
# on noise), WORLD's unvoiced-frame convention.
DEFAULT_UNVOICED_F0 = 500.0

# reflect padding (bins) for the rectangular smoothing at the spectrum
# edges; covers the widest smoothing window (2·500/3 Hz at fs=16k,
# dftlen=1024 ≈ 21 bins) with margin
_EDGE_PAD = 48


def lerp_gather(values: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Batched linear interpolation along the last axis: values (..., n),
    pos (..., m) fractional indices (clamped) → (..., m).

    The base index is clamped as an INTEGER to [0, n − 2]: clamping the
    float position to n − 1 − ε is not enough, since for n ≥ ~1025 the f32
    value rounds back up to n − 1 and i0 + 1 would fall outside the table;
    and a NaN position (NaN features) reads NaN, as the JAX gather's clamp
    makes it, instead of indexing out of bounds."""
    n = values.shape[-1]
    p = torch.clamp(pos, 0.0, float(n - 1))
    i0 = torch.clamp(torch.floor(p).long(), 0, n - 2)
    fr = p - i0.to(values.dtype)
    lead = torch.broadcast_shapes(values.shape[:-1], pos.shape[:-1])
    vals = values.expand(*lead, n)
    i0 = i0.expand(*lead, pos.shape[-1])
    lo = torch.gather(vals, -1, i0)
    hi = torch.gather(vals, -1, i0 + 1)
    return lo * (1.0 - fr) + hi * fr


def _time_smooth(P: torch.Tensor, radius: int, vuv=None) -> torch.Tensor:
    """Triangular smoothing of (B, nf, bins) along the frame axis,
    edge-replicated. When ``vuv`` (B, nf) is given, only neighbours with the
    SAME voicing state contribute: smoothing across a voicing boundary mixes
    a loud voiced neighbour's power into quiet unvoiced frames."""
    if radius <= 0:
        return P
    v = None if vuv is None else (vuv > 0.5)
    acc = (radius + 1.0) * P
    den = torch.full(P.shape[:2] + (1,), radius + 1.0, dtype=P.dtype, device=P.device)
    for k in list(range(-radius, 0)) + list(range(1, radius + 1)):
        w = radius + 1.0 - abs(k)
        m = 1.0 if v is None else (shift_frames(v, k) == v).to(P.dtype)[..., None]
        acc = acc + w * m * shift_frames(P, k)
        den = den + w * m
    return acc / den


def cheaptrick_envelope(
    x: torch.Tensor,
    f0: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    f0_floor: float = 60.0,
    q1: float = -0.15,
    time_smooth: int = 0,
    mirror_mask=None,
) -> torch.Tensor:
    """Log-amplitude spectral envelope, ``(B, nf, dftlen//2 + 1)``.

    x: ``(B, n)`` waveforms; f0: ``(B, nf)`` per-frame f0 in Hz (any
    positive value per frame; the caller decides voicing), nf = ceil(n /
    hop) frames centred at i·hop. ``mirror_mask`` ``(B, nf)`` ∈ {0, 1} is the
    voicing decision and gates the TIME smoothing only (see
    ``_time_smooth``); the sub-f0 fill is gated on the measured sub-f0
    deficit of every frame. None = ungated time smoothing."""
    bins = dftlen // 2 + 1
    Lmax = int(math.ceil(3.0 * fs / f0_floor))
    if Lmax > dftlen:
        raise ValueError(f"dftlen {dftlen} < 3·fs/f0_floor = {Lmax}; raise dftlen or f0_floor")
    dev = x.device
    f0c = torch.clamp(f0, f0_floor, fs / 6.0)  # window 3·T0 must fit Lmax

    frames = frame_signal(x, Lmax, hop)  # (B, nf, Lmax) centred at i·hop

    # --- 1. f0-adaptive Hanning window over the static frame length ------- #
    half = rdiv(1.5 * fs, f0c)  # (B, nf) half window length in samples
    t = torch.arange(Lmax, dtype=torch.float32, device=dev) - (Lmax // 2)
    inwin = torch.abs(t) <= half[..., None]
    w = torch.where(inwin, 0.5 + 0.5 * torch.cos(math.pi * t / half[..., None]), 0.0)
    wsum2 = torch.clamp(torch.sum(w * w, dim=-1), min=1e-12)  # (B, nf)

    # --- 2. normalized power spectrum + DC mirroring below f0 ------------- #
    X = torch.fft.rfft(frames * w, n=dftlen, dim=-1)
    P = (X.real * X.real + X.imag * X.imag) / wsum2[..., None]  # (B, nf, bins)
    P = _time_smooth(P, time_smooth, vuv=mirror_mask)

    dfreq = fs / dftlen
    b = torch.arange(bins, dtype=torch.float32, device=dev)
    f0_bins = f0c / dfreq  # (B, nf)
    mirror_pos = 2.0 * f0_bins[..., None] - b  # reflect around f0
    below = b < f0_bins[..., None]
    # deficit-gated fill: harmonic frames have no energy below f0 and need
    # the mirror; noise frames have real sub-f0 content that mirroring
    # would double-count. The gate is the measured sub-f0 deficit itself.
    taps = torch.zeros_like(P)
    for j in range(-2, 3):
        lo = torch.clamp(torch.arange(bins, device=dev) + j, 0, bins - 1)
        taps = taps + P[..., lo]
    Ps5 = taps / 5.0  # lightly pre-smoothed P for the gate measurement
    p_half = lerp_gather(Ps5, 0.5 * f0_bins[..., None])  # (B, nf, 1)
    p_f0 = lerp_gather(Ps5, f0_bins[..., None])
    w_fill = torch.clamp(1.0 - p_half / torch.clamp(p_f0, min=1e-20), 0.0, 1.0)
    P = torch.where(below, P + w_fill * lerp_gather(P, mirror_pos), P)

    # --- 3. rectangular smoothing, width 2·f0/3 ---------------------------- #
    # local shifted-taps sum with fractional edge weights, not a cumulative
    # sum (whose float32 differences cancel on wide dynamic ranges)
    pad = _EDGE_PAD
    Pp = torch.cat(
        [P[..., 1 : pad + 1].flip(-1), P, P[..., bins - 1 - pad : bins - 1].flip(-1)], dim=-1
    )  # reflect-padded, (B, nf, bins + 2·pad)
    wb = torch.clamp((2.0 * f0_bins / 3.0)[..., None], max=float(pad))  # bins
    J = pad // 2 + 1
    acc = torch.zeros_like(P)
    for j in range(-J, J + 1):
        wgt = torch.clamp(0.5 * wb + 0.5 - abs(j), 0.0, 1.0)  # (B, nf, 1)
        acc = acc + wgt * Pp[..., pad + j : pad + j + bins]
    S = acc / wb

    # --- 4. log + quefrency liftering -------------------------------------- #
    L = torch.log(torch.clamp(S, min=1e-20))
    cep = torch.fft.irfft(L.to(torch.complex64), n=dftlen, dim=-1)  # (B, nf, dftlen)
    tau = torch.arange(dftlen, dtype=torch.float32, device=dev)
    qq = torch.minimum(tau, dftlen - tau) / fs  # symmetric quefrency (s)
    arg = math.pi * f0c[..., None] * qq
    ls = torch.where(arg > 1e-6, torch.sin(arg) / torch.clamp(arg, min=1e-6), 1.0)
    lq = (1.0 - 2.0 * q1) + 2.0 * q1 * torch.cos(2.0 * arg)
    env_logpow = torch.fft.rfft(cep * ls * lq, dim=-1).real[..., :bins]

    # --- amplitude convention ---------------------------------------------- #
    off = torch.log(f0c * CAL / dfreq)
    env = 0.5 * (env_logpow + off[..., None])

    # Nyquist hold: hold the level measured at fs/2 − 2.5·f0 above it, on
    # every frame (a warped-band representation cannot carry "flat then
    # dip" at its top edge)
    hold_pos = (bins - 1.0) - 2.5 * f0_bins  # per-frame hold start (bins)
    hold_val = lerp_gather(env, hold_pos[..., None])  # (B, nf, 1)
    above = b > hold_pos[..., None]
    return torch.where(above, hold_val, env)
