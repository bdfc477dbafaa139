"""Per-harmonic aperiodicity (noise-fraction) and harmonic-envelope
estimation, batched.

Counterpart of ``percivaltts_tpu/ops/aperiodicity.py`` with a leading batch
axis (signals ``(B, n)``, tracks ``(B, nf)``): the harmonic envelope, the
per-harmonic noise mask and the D4C-family group-delay aperiodicity, over
either peak/valley reader. The default (``psync=True``) resamples
``ps_periods`` pitch periods to a fixed ``PS_N``-sample frame, so harmonic k
lands exactly on bin ``ps_periods·k`` and the inter-harmonic bins are exact
nulls of both neighbours; ``ps_reflect`` folds, and ``ps_shift`` slides, a
window that would cross the nearest voicing flip back into the frame's own
voicing run (both need ``vuv``). ``psync=False`` reads a 4·T0 Hann window
at k·f0 and at the (k ± ½)·f0 nulls, and the module constant
``VALLEY_8T0`` adds an 8·T0 window's valleys. The calibration constants
are the JAX package's (measured there; see that module for their
derivations, and for the measurements that keep the variants off by
default).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from percivaltts_tpu_torch.config import AnalysisParams
from percivaltts_tpu_torch.ops.cheaptrick import CAL, _time_smooth
from percivaltts_tpu_torch.ops.cheaptrick import lerp_gather as lerp_cols  # one impl
from percivaltts_tpu_torch.ops.morph import erode1d
from percivaltts_tpu_torch.ops.stft import frame_signal, num_frames, rdiv
from percivaltts_tpu_torch.ops.warp import _band_centers_hz

DEFAULT_ANALYSIS = AnalysisParams()

# harmonic mainlobe power / peak for the 4·T0 Hann convention, in units of
# the per-f0-interval noise integral (analytically 3/8)
NM_RHO = 0.375
# resampled pitch-synchronous frame length
PS_N = 2048
# peak power → harmonic amplitude² calibration of the 4·T0 Hann convention
ENV_PK = 1.5
# valley convention factor of the resampled reader (white noise of
# per-sample variance σ² reads σ²)
PS_NOISE_CAL = 1.0
# group-delay statistic: pure-noise asymptote, pure-harmonic floor, and the
# exponent of the measured mixture law r' ≈ 1 − (1 − a)³
GD_NOISE_VAR = 0.481
GD_FLOOR = 0.026
GD_MIX_EXP = 3.0
# psync=False only: read the valleys from an additional 8·T0 window at the
# {k ± 3/8, k ± 1/2, k ± 5/8}·f0 points (measured worse; kept off, and a
# module constant rather than a config field, as in the JAX package)
VALLEY_8T0 = False


def erode5(x: torch.Tensor) -> torch.Tensor:
    """Running minimum over ±2 frames along the frame axis (edge-replicated):
    removes the aperiodicity spike of the analysis window straddling a
    voicing edge."""
    return erode1d(x, 2)


def _periodic_hann(device):
    """(the periodic Hann window of PS_N samples, its sample indices)."""
    n = torch.arange(PS_N, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / PS_N), n


def _flip_bounds(vuv, nf, hop):
    """((B, nf, 1), (B, nf, 1)): the nearest voicing flip (frame-granular,
    midway between the two frame centres, in samples) strictly left and
    right of each frame centre; ∓1e9 where there is none."""
    v = vuv[:, :nf] > 0.5
    flips = v[:, 1:] != v[:, :-1]  # (B, nf − 1): a flip between frames i and i + 1
    bnd = (torch.arange(nf - 1, dtype=torch.float32, device=vuv.device) + 0.5) * hop
    far = torch.full_like(bnd[:1].expand(v.shape[0], 1), 1e9)
    left = torch.cummax(torch.where(flips, bnd, -1e9), dim=1).values
    right = torch.cummin(torch.where(flips, bnd, 1e9).flip(1), dim=1).values.flip(1)
    return torch.cat([-far, left], dim=1)[..., None], torch.cat([right, far], dim=1)[..., None]


def _psync_frames(wav, f0c, fs, hop, nf, vuv=None, ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Pitch-synchronously resampled analysis frames, ``(B, nf, PS_N)``:
    ``ap.ps_periods`` pitch periods, centred on each frame, linearly
    resampled to ``PS_N`` samples. With ``ap.ps_shift`` a window that would
    cross the nearest voicing flip slides as a whole (by whole periods with
    ``ap.ps_shift_snap``) into the frame's own voicing run, where it fits;
    with ``ap.ps_reflect`` its positions past the flip fold back once and
    are clamped to the run. Both need ``vuv``."""
    if (ap.ps_reflect or ap.ps_shift) and vuv is None:
        raise ValueError(
            "AnalysisParams.ps_reflect/ps_shift=True requires the vuv track "
            "to be threaded into the peak/valley reader (got vuv=None)"
        )
    dev = wav.device
    B, n = wav.shape
    span = rdiv(ap.ps_periods * fs, f0c)  # (B, nf) original samples per frame
    centers = torch.arange(nf, dtype=torch.float32, device=dev) * hop
    rel = (torch.arange(PS_N, dtype=torch.float32, device=dev) - PS_N / 2) / PS_N
    idx = centers[:, None] + rel * span[..., None]  # (B, nf, PS_N)
    if (ap.ps_reflect or ap.ps_shift) and nf > 1:
        left, right = _flip_bounds(vuv, nf, hop)
        c = centers[:, None]
        if ap.ps_shift:
            half = 0.5 * span[..., None]
            over_r = torch.clamp(c + half - right, min=0.0)
            over_l = torch.clamp(left - (c - half), min=0.0)
            if ap.ps_shift_snap:
                T0 = rdiv(float(fs), f0c)[..., None]
                over_r = torch.ceil(over_r / T0) * T0
                over_l = torch.ceil(over_l / T0) * T0
            delta = over_l - over_r
            new_c = c + delta
            fits = (new_c - half >= left) & (new_c + half <= right)
            idx = idx + torch.where(fits, delta, 0.0)
        else:
            idx = torch.where(idx > right, 2.0 * right - idx, idx)
            idx = torch.where(idx < left, 2.0 * left - idx, idx)
            # degenerate 1-frame runs can still escape after one fold
            idx = torch.minimum(torch.maximum(idx, left), right)
    idx = torch.clamp(idx, 0.0, n - 1.001)
    i0 = torch.floor(idx).long()
    frac = (idx - i0).to(wav.dtype)
    # the reads clamped to the signal as the JAX gather clamps them: from
    # n ≈ 16k samples on, the f32 bound n − 1.001 rounds up to n − 1 and
    # i0 + 1 would read past the end (where frac is 0); a NaN position reads
    # NaN instead of indexing out of bounds
    flat = torch.clamp(i0.reshape(B, -1), 0, n - 1)
    lo = torch.gather(wav, 1, flat).reshape(idx.shape)
    hi = torch.gather(wav, 1, torch.clamp(flat + 1, max=n - 1)).reshape(idx.shape)
    return lo * (1.0 - frac) + hi * frac


def _psync_peaks_valleys(wav, f0c, fs, hop, nf, K, vuv=None,
                         ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Pitch-synchronous exact-bin (peak, valley), ``(B, nf, K)`` each, in
    the 4·T0 reader's conventions (peak: a² = peak·ENV_PK·f0/fs; valley:
    white noise of per-sample variance σ² reads σ²)."""
    periods = ap.ps_periods
    seg = _psync_frames(wav, f0c, fs, hop, nf, vuv=vuv, ap=ap)
    win, _ = _periodic_hann(wav.device)
    wsum2 = torch.sum(win * win)
    X = torch.fft.rfft(seg * win, dim=-1)
    P = (X.real * X.real + X.imag * X.imag) / wsum2  # (B, nf, N/2+1)

    ks = torch.arange(1, K + 1, device=wav.device)
    pk_bins = periods * ks  # exact harmonic bins
    fk = ks.to(torch.float32) * f0c[..., None]  # (B, nf, K) Hz

    def corr(fhz):
        # the linear interpolator's |sinc(f/fs)|⁴ power roll-off, divided out
        x = math.pi * fhz / fs
        s = torch.where(x > 1e-6, torch.sin(x) / torch.clamp(x, min=1e-6), 1.0)
        return 1.0 / torch.clamp(s * s * s * s, min=1e-3)

    cap = PS_N // 2 - periods  # last fully-representable bin
    pk_bins_c = torch.clamp(pk_bins, max=cap)
    acc = 0.0
    # inter-harmonic bins outside both neighbours' 3-bin Hann kernels
    offs = tuple(range(-(periods - 2), -1)) + tuple(range(2, periods - 1))
    for o in offs:
        bins_o = torch.clamp(pk_bins_c + o, 1, PS_N // 2)
        fo = fk + o * f0c[..., None] / periods
        acc = acc + P[..., bins_o] * corr(torch.abs(fo))
    vraw = acc / len(offs)  # noise bin-PSD in psync P units
    rate_ratio = rdiv(periods * fs, PS_N * f0c[..., None])
    valley = vraw * rate_ratio * PS_NOISE_CAL
    a2 = torch.clamp(P[..., pk_bins_c] * corr(fk) - vraw, min=0.0) * (6.0 / PS_N)
    peak = a2 * fs / (ENV_PK * f0c[..., None]) + valley
    return peak, valley


def _windowed_power(wav, f0c, fs, hop, L, halfw_periods, time_smooth=0, vuv=None):
    """(power spectra ``(B, nf, nfft//2 + 1)``, nfft): L-sample frames
    centred at i·hop under a Hann window of half-width ``halfw_periods``
    pitch periods, zero-padded to the next power of two, each normalized by
    its window's Σw² (white noise of per-sample variance σ² reads σ² a
    bin); ``time_smooth`` smooths the spectra over frames."""
    nfft = 1 << (L - 1).bit_length()
    frames = frame_signal(wav, L, hop)  # (B, nf, L), centred at i·hop
    halfw = rdiv(halfw_periods * fs, f0c)[..., None]  # (B, nf, 1)
    t = torch.arange(L, dtype=torch.float32, device=wav.device) - (L // 2)
    w = torch.where(torch.abs(t) <= halfw, 0.5 + 0.5 * torch.cos(math.pi * t / halfw), 0.0)
    wsum2 = torch.clamp(torch.sum(w * w, dim=-1), min=1e-12)
    X = torch.fft.rfft(frames * w, n=nfft, dim=-1)
    P = (X.real * X.real + X.imag * X.imag) / wsum2[..., None]
    if time_smooth:
        P = _time_smooth(P, time_smooth, vuv=vuv)
    return P, nfft


def _peaks_valleys(wav, f0, fs, hop, f0_floor, time_smooth=0, vuv=None,
                   ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Per-harmonic (peak, valley, k, f0c): power at k·f0 and the
    inter-harmonic noise level, ``(B, nf, K)`` each, from the
    pitch-synchronous reader (``time_smooth`` smooths both per-harmonic
    tracks over frames, voicing-partitioned when ``vuv`` is given) or, with
    ``ap.psync=False``, from the 4·T0 window's power spectrum (smoothed over
    frames before it is read)."""
    Lnm = int(math.ceil(4.0 * fs / f0_floor))
    f0c = torch.clamp(f0, f0_floor, fs / 8.0)
    K = int(fs / 2.0 / f0_floor)
    k = torch.arange(1, K + 1, dtype=torch.float32, device=wav.device)
    if ap.psync:
        nf = num_frames(wav.shape[-1], Lnm, hop)
        peak, valley = _psync_peaks_valleys(wav, f0c, fs, hop, nf, K, vuv=vuv, ap=ap)
        if time_smooth:
            peak = _time_smooth(peak, time_smooth, vuv=vuv)
            valley = _time_smooth(valley, time_smooth, vuv=vuv)
        return peak, valley, k, f0c

    P4, fftnm = _windowed_power(wav, f0c, fs, hop, Lnm, 2.0, time_smooth, vuv)
    f0bins = (f0c * fftnm / fs)[..., None]  # (B, nf, 1)
    kpos = f0bins * k  # (B, nf, K)
    peak = lerp_cols(P4, kpos)
    # only the exact (k ± ½)·f0 nulls are clean valley reads
    valley = 0.5 * (lerp_cols(P4, kpos - 0.5 * f0bins) + lerp_cols(P4, kpos + 0.5 * f0bins))
    if VALLEY_8T0:
        Lnm8 = int(math.ceil(8.0 * fs / f0_floor))
        P8, fft8 = _windowed_power(wav, f0c, fs, hop, Lnm8, 4.0, time_smooth, vuv)
        f0bins8 = (f0c * fft8 / fs)[..., None]
        kpos8 = f0bins8 * k
        acc = 0.0
        offs = (0.375, 0.5, 0.625)
        for o in offs:
            acc = acc + lerp_cols(P8, kpos8 - o * f0bins8)
            acc = acc + lerp_cols(P8, kpos8 + o * f0bins8)
        valley = acc / (2.0 * len(offs))
    return peak, valley, k, f0c


def harmonic_noise_mask(wav, f0, fs, hop, num_bands, f0_floor, valley_smooth=0, vuv=None,
                        ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Per-harmonic noise fraction ``v / (v + NM_RHO·(p − v))`` mapped to
    warped bands, ``(B, nf, bands)``: 0 = harmonic band, 1 = noise band.
    ``valley_smooth`` > 0 smooths the per-harmonic valley track first."""
    peak, valley, k, f0c = _peaks_valleys(wav, f0, fs, hop, f0_floor, vuv=vuv, ap=ap)
    if valley_smooth:
        valley = _time_smooth(valley, valley_smooth, vuv=vuv)
    harmpow = torch.clamp(peak - valley, min=0.0)
    nm_k = valley / torch.clamp(valley + NM_RHO * harmpow, min=1e-20)
    # harmonics at/above Nyquist carry no deterministic content
    nm_k = torch.where((k + 0.5) * f0c[..., None] < fs / 2.0, nm_k, 1.0)
    centers = torch.as_tensor(_band_centers_hz(num_bands, fs), dtype=torch.float32,
                              device=wav.device)
    hpos = centers / f0c[..., None] - 1.0  # harmonic-index space
    return torch.clamp(lerp_cols(nm_k, hpos), 0.0, 1.0)


def harmonic_envelope(wav, f0, fs, hop, dftlen, f0_floor, time_smooth=0, vuv=None,
                      ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Phase-insensitive log-amplitude envelope from the harmonic peaks and
    valleys, ``(B, nf, dftlen//2 + 1)``, in ``ops.cheaptrick``'s amplitude
    convention; between harmonics it is interpolated in harmonic-index
    space, and it holds below h1 and above the last sub-Nyquist harmonic.
    With ``ap.ps_shift_nm_only`` the envelope reads frame-centred windows
    (the shift applies to the noise mask alone)."""
    if ap.ps_shift and ap.ps_shift_nm_only:
        ap = dataclasses.replace(ap, ps_shift=False)
    peak, valley, k, f0c = _peaks_valleys(
        wav, f0, fs, hop, f0_floor, time_smooth=time_smooth, vuv=vuv, ap=ap
    )
    # extra ±3-frame smoothing of the 2-draw valley reading
    valley_sm = _time_smooth(valley, 3, vuv=vuv)
    a2 = torch.clamp(peak - valley, min=0.0) * ENV_PK * (f0c / fs)[..., None]
    n2 = valley_sm * (f0c * CAL * dftlen / fs)[..., None]
    A2 = torch.clamp(a2 + n2, min=1e-20)
    # harmonics at/above Nyquist hold the last valid harmonic's level: the
    # forward fill of the JAX scan, as a running max of valid indices
    valid = (k + 0.5) * f0c[..., None] < fs / 2.0
    logA_k = 0.5 * torch.log(A2)
    K = logA_k.shape[-1]
    ar = torch.arange(K, device=wav.device)
    last = torch.cummax(torch.where(valid, ar, 0), dim=-1).values
    logA_k = torch.gather(logA_k, -1, last)

    bins = dftlen // 2 + 1
    freqs = torch.arange(bins, dtype=torch.float32, device=wav.device) * fs / dftlen
    hpos = freqs / f0c[..., None] - 1.0  # harmonic-index space
    return lerp_cols(logA_k, hpos)  # clamped: holds h1 below f0


def group_delay_aperiodicity(wav, f0, fs, hop, num_bands, f0_floor, vuv=None,
                             ap: AnalysisParams = DEFAULT_ANALYSIS):
    """Band aperiodicity from the group-delay statistic (D4C family),
    ``(B, nf, bands)`` in [0, 1] on the warped band axis: the energy-weighted
    variance of the group delay over ``ap.gd_band_hz``-wide coarse bands of
    the pitch-synchronous frames, through the inverse of the measured
    mixture law, interpolated to the band centres."""
    f0c = torch.clamp(f0.to(torch.float32), f0_floor, fs / 2.0)
    nf = f0c.shape[-1]
    dev = wav.device
    seg = _psync_frames(wav, f0c, fs, hop, nf, vuv=vuv, ap=ap)
    win, n = _periodic_hann(dev)
    nc = n - PS_N / 2
    X = torch.fft.rfft(seg * win, dim=-1)
    Xd = torch.fft.rfft(seg * win * nc, dim=-1)
    P = X.real * X.real + X.imag * X.imag  # (B, nf, N/2+1)
    # group delay in resampled samples, over the window's RMS time spread
    tw2 = torch.sum(win * win * nc * nc) / torch.sum(win * win)
    tau = (Xd.real * X.real + Xd.imag * X.imag) / torch.clamp(P, min=1e-30)
    u = tau / torch.sqrt(tw2)

    # per-frame frequency of each resampled bin, in original Hz
    bins = torch.arange(PS_N // 2 + 1, dtype=torch.float32, device=dev)
    fbin = bins * f0c[..., None] / ap.ps_periods  # (B, nf, nbins)
    # usable bins: above DC's mainlobe, below both the original Nyquist and
    # the last fully-representable resampled bin
    cap_hz = (PS_N // 2 - ap.ps_periods) * f0c / ap.ps_periods
    usable = (bins >= 2.0) & (fbin < torch.clamp(cap_hz[..., None], max=fs / 2.0))

    band_hz = float(ap.gd_band_hz)
    n_coarse = max(int(math.ceil((fs / 2.0) / band_hz)), 1)
    edges = torch.arange(n_coarse + 1, dtype=torch.float32, device=dev) * band_hz
    a_coarse = []
    for b in range(n_coarse):
        m = usable & (fbin >= edges[b]) & (fbin < edges[b + 1])
        w = torch.where(m, P, 0.0)
        tot = torch.clamp(torch.sum(w, dim=-1), min=1e-30)
        mu = torch.sum(w * u, dim=-1) / tot
        s2 = torch.sum(w * (u - mu[..., None]) ** 2, dim=-1) / tot
        # bands with (numerically) no usable energy read 1.0 (pure noise)
        has = torch.sum(m.to(torch.float32), dim=-1) > 2.0
        rp = torch.clamp((s2 - GD_FLOOR) / (GD_NOISE_VAR - GD_FLOOR), 0.0, 1.0)
        a_b = 1.0 - (1.0 - rp) ** (1.0 / GD_MIX_EXP)
        a_coarse.append(torch.where(has, a_b, 1.0))
    a_coarse = torch.stack(a_coarse, dim=-1)  # (B, nf, n_coarse)

    # expand to the warped band axis: linear interpolation between coarse
    # band centres
    centers_hz = torch.as_tensor(_band_centers_hz(num_bands, fs), dtype=torch.float32,
                                 device=dev)
    ccenters = (edges[:-1] + edges[1:]) / 2.0
    pos = (centers_hz - ccenters[0]) / band_hz  # fractional coarse index
    return torch.clamp(lerp_cols(a_coarse, pos.expand(*a_coarse.shape[:-1], num_bands)), 0.0, 1.0)
