"""PML-style vocoder: f0 + warped log spectral envelope + warped noise mask.

Counterpart of ``percivaltts_tpu/vocoders/pml.py`` for the three envelopes
("harmonic", the default; "cheaptrick"; "te"), every ``AnalysisParams``
reader and any ``closed_loop`` count, with ``vmap`` written out as a
leading batch axis: the cores take ``(B, nf, ·)`` features and ``(B, n)``
waveforms and run on the device of their inputs. Per-frame features are

* ``lf0``  — log of the continuous f0 track (interpolated through unvoiced),
* ``spec`` — frequency-warped log spectral amplitude envelope,
* ``nm``   — frequency-warped noise mask ∈ [0, 1] (1 on unvoiced frames).

Analysis (``pml_analyze_core``): YIN (``ops/f0.py``), on voiced frames the
harmonic peak/valley envelope (or, with ``envelope="cheaptrick"``, the
f0-adaptive CheapTrick envelope) and on unvoiced ones the 500 Hz CheapTrick
envelope, the group-delay noise mask, warping as constant matmuls. With
``envelope="te"`` (the round-1 estimator): the true envelope
(``ops/envelope.py``) of the fixed-window log STFT magnitude on every frame
and the harmonicity noise mask r(τ0)/r(0) (``te_noise_mask``).
Synthesis (``pml_synthesize_amp_core``): a bank of harmonics of the
continuous f0 with the envelope's minimum phase, gated by voicing, plus
phase-only noise shaped to the per-band power the analyzer reads back.
``pml_closed_loop_core`` renders, re-analyzes and corrects the spec stream
``iters`` times. "te" features render open loop through
``pml_synthesize_core`` (zero-phase harmonics in the STFT-magnitude
convention plus STFT-shaped noise), whatever ``closed_loop`` says, as in
the JAX package. On the card the framing and overlap-add inside run in the
hand-written kernels of ``ops/frames_cuda.py``.

The noise is an argument of the cores: ``PMLVocoder._noise`` draws it from
a ``torch.Generator`` seeded with ``seed`` (the JAX package draws
``jax.random.normal``, which torch cannot reproduce; the parity tests hand
the JAX draw to the port). As in the JAX package, one draw of
``nf_pad·hop`` samples serves every row of a chunk and every render of the
closed loop.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from percivaltts_tpu_torch.config import AnalysisParams
from percivaltts_tpu_torch.ops.aperiodicity import (
    DEFAULT_ANALYSIS,
    erode5,
    group_delay_aperiodicity,
    harmonic_envelope,
    harmonic_noise_mask,
)
from percivaltts_tpu_torch.ops.cheaptrick import (
    CAL,
    DEFAULT_UNVOICED_F0,
    cheaptrick_envelope,
    lerp_gather,
)
from percivaltts_tpu_torch.ops.envelope import spectral_envelope
from percivaltts_tpu_torch.ops.f0 import estimate_f0
from percivaltts_tpu_torch.ops.morph import dilate1d, erode1d, fill_from_interior, shift_frames
from percivaltts_tpu_torch.ops.stft import hann_window, istft, rdiv, stft
from percivaltts_tpu_torch.ops.warp import unwarp_matrix, warp_matrix
from percivaltts_tpu_torch.vocoders.base import (
    FRAME_MULTIPLE,
    Vocoder,
    chunked_synthesize_batch,
    register,
)

# Calibration of the stochastic component (the JAX package's, pinned there
# by the nm = 1 roundtrip measurement).
NOISE_CAL = 0.97
# depth of the pulse-synchronous noise modulation in voiced regions
NOISE_MOD = 0.4

# the spectral envelope estimators (``VocoderConfig.envelope``)
ENVELOPES = ("harmonic", "cheaptrick", "te")


def check_envelope(envelope: str) -> None:
    """Raise ``ValueError`` for a name outside ``ENVELOPES``. (The JAX
    package reads any other name as "te" in PML and as 500 Hz CheapTrick in
    WORLD; the port refuses it instead.)"""
    if envelope not in ENVELOPES:
        raise ValueError(f"unknown envelope {envelope!r}: one of {ENVELOPES}")


def env_halfw_for(envelope: str) -> float:
    """Analysis-window half-width (units of T0) of the given envelope
    estimator, for the amplitude-sharpening inverse in
    ``pml_synthesize_amp_core``: "harmonic" reads 4·T0 windows (2.0),
    "cheaptrick" 3·T0 (1.5); anything else disables sharpening (0.0)."""
    return {"harmonic": 2.0, "cheaptrick": 1.5}.get(envelope, 0.0)


def seeded_noise(n: int, seed: int, device) -> torch.Tensor:
    """``(n,)`` standard-normal samples from a generator on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, device=device)


def analysis_kw(c) -> dict:
    """The analysis cores' keyword arguments from a ``VocoderConfig``."""
    return dict(fs=c.fs, hop=c.shift_samples, dftlen=c.dftlen, spec_size=c.spec_size,
                nm_size=c.nm_size, f0_min=c.f0_min, f0_max=c.f0_max, envelope=c.envelope,
                env_time_smooth=c.env_time_smooth, ap=c.analysis)


def _const(a: np.ndarray, device) -> torch.Tensor:
    """A numpy constant (float64 or float32) as a float32 tensor, as the JAX
    package's ``jnp.asarray`` makes it under its default precision."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _shift_zero(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` moved by ``k`` frames along axis 1, zero-filled."""
    nf = x.shape[1]
    z = torch.zeros_like(x[:, : min(abs(k), nf)])
    if k > 0:
        return torch.cat([x[:, k:], z], dim=1)
    return torch.cat([z, x[:, : nf + k]], dim=1)


def _smooth_noiselike(x: torch.Tensor, noisiness: torch.Tensor, radius: int = 5) -> torch.Tensor:
    """Box-smooth ``(B, nf, bands)`` features over time within noise-like
    runs, gated by the continuous noisiness (``(B, nf)`` per frame or
    ``(B, nf, bands)`` per band, soft-thresholded): noise spectra carry
    per-frame estimator variance that averaging across noise-like
    neighbours cuts."""
    if noisiness.dim() == x.dim() - 1:
        noisiness = noisiness[..., None]
    s = torch.clamp((noisiness - 0.45) / 0.35, 0.0, 1.0)
    num, den = x * s, s
    acc_n, acc_d = num, den
    for k in range(1, radius + 1):
        acc_n = acc_n + _shift_zero(num, k) + _shift_zero(num, -k)
        acc_d = acc_d + _shift_zero(den, k) + _shift_zero(den, -k)
    sm = acc_n / torch.clamp(acc_d, min=1e-6)
    return (1.0 - s) * x + s * sm


def _nm_to_spec_matrix(nm_size: int, spec_size: int) -> np.ndarray:
    """(nm_size, spec_size) linear interpolation from the noise-mask bands
    to the spec bands (both mel-uniform)."""
    ji = np.arange(spec_size) * (nm_size - 1) / max(spec_size - 1, 1)
    j0 = np.clip(ji.astype(np.int32), 0, nm_size - 2)
    M = np.zeros((nm_size, spec_size), np.float32)
    M[j0, np.arange(spec_size)] = 1.0 - (ji - j0)
    M[j0 + 1, np.arange(spec_size)] += ji - j0
    return M


def _smooth_noise_bands(spec_w: torch.Tensor, gate_raw: torch.Tensor) -> torch.Tensor:
    """``_smooth_noiselike`` of the ``(B, nf, S)`` spec stream, shared by the
    PML and WORLD analyses, gated per band by the ``(B, nf, M)`` raw
    noisiness interpolated to the spec bands, 5-band box-smoothed, at least
    the frame's mean, then eroded."""
    spec_size = spec_w.shape[-1]
    M = _nm_to_spec_matrix(gate_raw.shape[-1], spec_size)
    nm_spec = gate_raw @ _const(M, gate_raw.device)
    first, last = nm_spec[..., :1], nm_spec[..., -1:]
    pad = torch.cat([first, first, nm_spec, last, last], dim=-1)
    nm_band = sum(pad[..., i : i + spec_size] for i in range(5)) / 5.0
    gate = torch.maximum(nm_band, gate_raw.mean(dim=-1, keepdim=True))
    return _smooth_noiselike(spec_w, erode5(gate))


def _envelope_w(wav, f0, vuv, fs, hop, dftlen, spec_size, f0_floor, envelope, time_smooth,
                ap: AnalysisParams = DEFAULT_ANALYSIS) -> torch.Tensor:
    """The warped log spectral envelope, ``(B, nf, spec_size)``, shared by
    the PML and WORLD analyses. Voiced frames: the phase-insensitive
    harmonic envelope ("harmonic") or CheapTrick keyed on the f0 track
    ("cheaptrick"); unvoiced frames: CheapTrick at WORLD's 500 Hz convention
    either way (the short window keeps loud voiced neighbours out of quiet
    boundary frames)."""
    f0_env = torch.where(vuv > 0.5, f0, DEFAULT_UNVOICED_F0)
    env = cheaptrick_envelope(
        wav, f0_env if envelope == "cheaptrick" else torch.full_like(f0, DEFAULT_UNVOICED_F0),
        fs, hop, dftlen, f0_floor=f0_floor, time_smooth=time_smooth, mirror_mask=vuv,
    )
    if envelope == "harmonic":
        env_v = harmonic_envelope(
            wav, f0, fs, hop, dftlen, f0_floor=f0_floor, time_smooth=time_smooth, vuv=vuv, ap=ap
        )
        env = torch.where(vuv[..., None] > 0.5, env_v, env)
    return env @ _const(warp_matrix(spec_size, dftlen, fs), wav.device)


def te_noise_mask(mag: torch.Tensor, f0: torch.Tensor, window: torch.Tensor, fs: int,
                  dftlen: int, nm_size: int) -> torch.Tensor:
    """The "te" analysis's noise mask from the ``(B, nf, bins)`` STFT
    magnitude under ``window``: per warped band, 1 − the harmonicity
    r(τ0)/r(0) at the pitch lag τ0 = fs / f0, from band-weighted sums of the
    power spectrum, unbiased by the window's own autocorrelation at τ0
    (lerped, clipped to [0.05, 1]) and clipped to [0, 1]."""
    dev = mag.device
    frame_len = window.shape[-1]
    P = mag.square()
    W_nm = _const(warp_matrix(nm_size, dftlen, fs), dev)
    tau0 = rdiv(float(fs), torch.clamp(f0, min=1.0))  # (B, nf) samples
    binidx = torch.arange(P.shape[-1], dtype=torch.float32, device=dev)
    # in JAX's order: the argument reaches ~800 rad, where the f32 rounding
    # of each product shows
    cosv = torch.cos((2.0 * math.pi) * binidx * tau0[..., None] / dftlen)
    r0 = torch.clamp(P @ W_nm, min=1e-12)
    rt = (P * cosv) @ W_nm
    n2 = 1 << (2 * frame_len - 1).bit_length()
    wac = torch.fft.irfft(torch.abs(torch.fft.rfft(window, n=n2)).square(), n=n2)
    bias_curve = wac[:frame_len] / torch.clamp(wac[0], min=1e-12)
    ti = torch.clamp(tau0, 0.0, frame_len - 2.0)
    i0 = torch.floor(ti).long()
    fr = ti - i0.to(torch.float32)
    bias = torch.clamp(bias_curve[i0] * (1.0 - fr) + bias_curve[i0 + 1] * fr, 0.05, 1.0)
    harm = torch.clamp((rt / r0) / bias[..., None], 0.0, 1.0)
    return 1.0 - harm


def pml_analyze_core(
    wav: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    spec_size: int,
    nm_size: int,
    f0_min: float,
    f0_max: float,
    envelope: str = "harmonic",
    env_time_smooth: int = 1,
    ap: AnalysisParams = DEFAULT_ANALYSIS,
    frame_len: int = 400,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, n)`` waveforms → (``(B, nf, 1 + spec + nm)`` features, ``(B, nf)``
    vuv), nf = ceil(n / hop). ``frame_len`` is the "te" analysis's STFT
    window; the other envelopes do not read it."""
    check_envelope(envelope)
    res = estimate_f0(wav, fs, hop, f0_min, f0_max)
    f0, vuv = res.f0, res.vuv
    lf0 = torch.log(torch.clamp(f0, min=1.0))
    if envelope == "te":
        # the true envelope of the log STFT magnitude on every frame, and
        # the harmonicity noise mask
        window = hann_window(frame_len, device=wav.device)
        mag = torch.abs(stft(wav, frame_len, hop, dftlen, window))
        _, env = spectral_envelope(torch.log(torch.clamp(mag, min=1e-8)), f0, fs, dftlen)
        spec_w = env @ _const(warp_matrix(spec_size, dftlen, fs), wav.device)
        nm = te_noise_mask(mag, f0, window, fs, dftlen, nm_size)
        nm = torch.where(vuv[..., None] > 0.5, nm, 1.0)
        return torch.cat([lf0[..., None], spec_w, nm], dim=-1), vuv

    f0_floor = min(f0_min, 60.0)
    spec_w = _envelope_w(wav, f0, vuv, fs, hop, dftlen, spec_size, f0_floor, envelope,
                         env_time_smooth, ap)

    nm_raw = harmonic_noise_mask(
        wav, f0, fs, hop, nm_size, f0_floor, valley_smooth=ap.nm_valley_smooth, vuv=vuv, ap=ap
    )
    gd_raw = None
    if ap.nm_method == "d4c_gd":
        gd_raw = group_delay_aperiodicity(wav, f0, fs, hop, nm_size, f0_floor, vuv=vuv, ap=ap)
        nm = erode5(gd_raw)
    elif ap.nm_method == "peak_valley":
        nm = erode5(nm_raw)
    else:
        raise ValueError(f"unknown AnalysisParams.nm_method: {ap.nm_method!r}")
    if ap.gate_nm_source == "d4c":
        if gd_raw is None:
            raise ValueError('gate_nm_source="d4c" requires nm_method="d4c_gd"')
        gate_raw = gd_raw
    elif ap.gate_nm_source == "peak_valley":
        gate_raw = nm_raw
    else:
        raise ValueError(f"unknown AnalysisParams.gate_nm_source: {ap.gate_nm_source!r}")
    spec_w = _smooth_noise_bands(spec_w, gate_raw)
    nm = torch.where(vuv[..., None] > 0.5, nm, 1.0)
    return torch.cat([lf0[..., None], spec_w, nm], dim=-1), vuv


def _harmonic_grid(f0, f0_min, fs, dftlen):
    """Static harmonic-count grid: (k numbers, (B, nf, K) fractional bin
    positions, validity mask below Nyquist)."""
    K = int(fs / 2.0 / f0_min)
    k = torch.arange(1, K + 1, dtype=torch.float32, device=f0.device)
    binpos = f0[..., None] * k * dftlen / fs
    valid = binpos < (dftlen / 2.0 - 1.0)
    return k, binpos, valid


def _frame_to_sample(nf, n, hop, device):
    """Per-sample frame interpolation coefficients: (i0, w1) with
    track_s = track[i0]·(1−w1) + track[i0+1]·w1."""
    frame_pos = torch.arange(n, dtype=torch.float32, device=device) / hop
    i0 = torch.clamp(torch.floor(frame_pos).long(), 0, nf - 2)
    w1 = frame_pos - i0.to(torch.float32)
    return i0, w1


def pml_synthesize_core(
    lf0: torch.Tensor,
    spec_w: torch.Tensor,
    nm_w: torch.Tensor,
    noise: torch.Tensor,
    fs: int,
    hop: int,
    frame_len: int,
    dftlen: int,
    f0_min: float,
    f0_max: float,
) -> torch.Tensor:
    """The open-loop render of "te" features: ``(B, nf)`` lf0, ``(B, nf, S)``
    warped log envelope in the STFT-magnitude convention and ``(B, nf, M)``
    warped noise mask → ``(B, nf·hop)`` waveforms, with the ``(nf·hop,)``
    white ``noise`` shared by every row. Zero-phase harmonics of the
    continuous f0 at amplitude (2/Σw)·A·√(1 − nm), plus the noise's STFT
    (``frame_len``-sample Hann frames) scaled to unit expected magnitude,
    shaped by A·√nm and inverted."""
    nf = lf0.shape[1]
    n = nf * hop
    if tuple(noise.shape) != (n,):
        raise ValueError(f"noise must be ({n},) for {nf} frames, got {tuple(noise.shape)}")
    dev = lf0.device
    f0 = torch.clamp(torch.exp(lf0), f0_min, f0_max * 1.5)
    A = torch.exp(spec_w @ _const(unwarp_matrix(spec_w.shape[-1], dftlen, fs), dev))
    nm_bins = torch.clamp(nm_w @ _const(unwarp_matrix(nm_w.shape[-1], dftlen, fs), dev), 0.0, 1.0)
    window = hann_window(frame_len, device=dev)

    # harmonic part: per-sample amplitudes (linear over frames), cosines of
    # the continuous phase
    k, binpos, valid = _harmonic_grid(f0, f0_min, fs, dftlen)
    amp_f = rdiv(2.0, torch.sum(window)) * lerp_gather(A, binpos) * torch.sqrt(
        torch.clamp(1.0 - lerp_gather(nm_bins, binpos), 0.0, 1.0)
    )
    amp_f = torch.where(valid, amp_f, 0.0)
    i0, w1 = _frame_to_sample(nf, n, hop, dev)
    f0_s = f0[:, i0] * (1.0 - w1) + f0[:, i0 + 1] * w1
    phase = 2.0 * np.pi * torch.cumsum(f0_s, dim=-1) / fs  # (B, n)
    w1c = w1[:, None]
    amp_s = amp_f[:, i0] * (1.0 - w1c) + amp_f[:, i0 + 1] * w1c  # (B, n, K)
    harm = torch.sum(amp_s * torch.cos(phase[..., None] * k), dim=-1)

    # noise part: E|N(f)|² = Σw² for unit-variance noise, so dividing by
    # √(Σw²) gives magnitude ~1, and A·√nm puts it in the envelope's STFT
    # convention; one noise STFT serves the whole batch
    Nspec = stft(noise[None], frame_len, hop, dftlen, window)[:, :nf]  # (1, nf, bins)
    norm = torch.sqrt(torch.sum(window * window))
    noise_wav = istft(Nspec / norm * (A * torch.sqrt(nm_bins)), frame_len, hop, n, window)
    return harm + noise_wav


def _vuv_low_bands(nm, ap: AnalysisParams = DEFAULT_ANALYSIS):
    """The noise-mask band slice the voicing rule reads (numpy or torch)."""
    return nm[..., : max(int(nm.shape[-1] * ap.vuv_low_frac), 1)]


def _vuv_from_nm(nm_w: torch.Tensor, ap: AnalysisParams = DEFAULT_ANALYSIS) -> torch.Tensor:
    """Voicing bit from the warped noise mask: the mean of its low bands
    below ``ap.vuv_threshold``."""
    return (torch.mean(_vuv_low_bands(nm_w, ap), dim=-1) < ap.vuv_threshold).to(torch.float32)


def pml_synthesize_amp_core(
    lf0: torch.Tensor,
    spec_w: torch.Tensor,
    nm_w: torch.Tensor,
    noise: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    f0_min: float,
    f0_max: float,
    env_halfw: float = 2.0,
    env_tri_radius: int = 1,
    ap: AnalysisParams = DEFAULT_ANALYSIS,
) -> torch.Tensor:
    """``(B, nf)`` lf0, ``(B, nf, S)`` warped log amplitude envelope and
    ``(B, nf, M)`` warped noise mask → ``(B, nf·hop)`` waveforms, with the
    ``(nf·hop,)`` white ``noise`` shared by every row. Harmonics carry the
    envelope's minimum phase; the stochastic part is the noise, phase-only,
    shaped to the per-band power the analyzer reads back and
    pitch-synchronously modulated in voiced regions."""
    nf = lf0.shape[1]
    n = nf * hop
    if tuple(noise.shape) != (n,):
        raise ValueError(f"noise must be ({n},) for {nf} frames, got {tuple(noise.shape)}")
    dev = lf0.device
    spec_size, nm_size = spec_w.shape[-1], nm_w.shape[-1]
    bins = dftlen // 2 + 1

    f0 = torch.clamp(torch.exp(lf0), f0_min, f0_max * 1.5)
    logA = spec_w @ _const(unwarp_matrix(spec_size, dftlen, fs), dev)  # (B, nf, bins)
    A = torch.exp(logA)
    nm_bins = torch.clamp(nm_w @ _const(unwarp_matrix(nm_size, dftlen, fs), dev), 0.0, 1.0)
    voiced_f = _vuv_from_nm(nm_w, ap)  # (B, nf) intended voicing

    # ---- harmonic part: amplitudes + minimum-phase offsets --------------- #
    # Time-sharpen voiced amplitudes (a ↦ 2a − C∗a, C the analysis window's
    # f0-adaptive smear composed with the ±env_tri_radius triangle), so the
    # re-analysis smear of the rendered amplitudes cancels to second order.
    if env_halfw > 0.0:
        halfw_f = rdiv(env_halfw * fs, f0 * hop)  # half-width in frames, (B, nf)
        RAD = 4
        taus = torch.arange(-RAD, RAD + 1, dtype=torch.float32, device=dev)
        Kw = torch.where(
            torch.abs(taus) < halfw_f[..., None],
            0.5 + 0.5 * torch.cos(np.pi * taus / halfw_f[..., None]),
            0.0,
        )  # Hann amplitude kernel, (B, nf, 2R+1)
        r = env_tri_radius
        if r > 0:
            tw = np.asarray([r + 1 - abs(s) for s in range(-r, r + 1)], np.float32)
            tw = tw / tw.sum()
            padded = torch.nn.functional.pad(Kw, (r, r))
            W = 2 * RAD + 1
            C = sum(float(tw[s + r]) * padded[..., r - s : r - s + W] for s in range(-r, r + 1))
        else:
            C = Kw
        C = C / torch.clamp(C.sum(dim=-1, keepdim=True), min=1e-9)
        vcol = voiced_f[..., None]
        # voicing-partitioned smear: only same-state frames contribute
        num = sum(C[..., RAD + t, None] * shift_frames(A * vcol, t) for t in range(-RAD, RAD + 1))
        den = sum(C[..., RAD + t, None] * shift_frames(vcol, t) for t in range(-RAD, RAD + 1))
        A_smear = num / torch.clamp(den, min=1e-6)
        A_h = torch.where(vcol > 0.5, torch.maximum(2.0 * A - A_smear, 0.2 * A), A)
    else:
        A_h = A

    k, binpos, valid = _harmonic_grid(f0, f0_min, fs, dftlen)
    amp_f = lerp_gather(A_h, binpos) * torch.sqrt(
        torch.clamp(1.0 - lerp_gather(nm_bins, binpos), 0.0, 1.0)
    )
    amp_f = torch.where(valid, amp_f, 0.0)

    # minimum phase of the envelope: fold the real cepstrum of log A onto
    # causal quefrencies; the imaginary part of its spectrum is the phase
    cep = torch.fft.irfft(logA.to(torch.complex64), n=dftlen, dim=-1)  # (B, nf, dftlen)
    tau = torch.arange(dftlen, device=dev)
    fold = torch.where(
        (tau == 0) | (tau == dftlen // 2), 1.0, torch.where(tau < dftlen // 2, 2.0, 0.0)
    ).to(torch.float32)
    phi_bins = torch.fft.rfft(cep * fold, dim=-1).imag[..., :bins]
    phi_f = torch.where(valid, lerp_gather(phi_bins, binpos), 0.0)  # (B, nf, K)

    # per-sample tracks (linear interp over frames)
    i0, w1 = _frame_to_sample(nf, n, hop, dev)

    def per_sample(track):  # (B, nf) → (B, n)
        return track[:, i0] * (1.0 - w1) + track[:, i0 + 1] * w1

    f0_s = per_sample(f0)
    phase = 2.0 * np.pi * torch.cumsum(f0_s, dim=-1) / fs  # (B, n)

    # Voicing-gated harmonic bank with de-smeared attacks: backfill the
    # first/last ap.edge_backfill frames of each voiced run from the nearest
    # interior frame, hold through the first unvoiced frame on each side,
    # and let a per-sample gate place a step-like attack at the boundary.
    vmask = (voiced_f > 0.5)[..., None]  # (B, nf, 1)
    prev_v, next_v = shift_frames(vmask, -1), shift_frames(vmask, 1)

    def hold1(x):
        fill = torch.where(prev_v, shift_frames(x, -1), torch.where(next_v, shift_frames(x, 1), x))
        return torch.where(vmask, x, fill)

    def backfill(x):
        clean = erode1d(vmask, ap.edge_backfill)
        filled, cm = fill_from_interior(x, clean, ap.edge_backfill)
        # runs shorter than 2·edge_backfill+1 have no clean interior
        return torch.where(vmask & cm, filled, x)

    amp_h = hold1(backfill(amp_f))
    phi_h = hold1(backfill(phi_f))
    w1c = w1[:, None]
    amp_s = amp_h[:, i0] * (1.0 - w1c) + amp_h[:, i0 + 1] * w1c  # (B, n, K)
    phi_s = phi_h[:, i0] * (1.0 - w1c) + phi_h[:, i0 + 1] * w1c

    # Gate position from the envelope's low-band energy E: the attack sits
    # where the analysis window's power fraction past the step,
    # w = exp(2·(E − E_plateau)), crosses ½.
    lowb = max(int(1500.0 * dftlen / fs), 8)
    E = torch.mean(logA[..., :lowb], dim=-1, keepdim=True)  # (B, nf, 1)
    Ev, rv = fill_from_interior(E, erode1d(vmask, 4), 8)
    Eu, ru = fill_from_interior(E, erode1d(~vmask, 2), 8)
    ok = rv & ru & ((Ev - Eu) > ap.gate_min_gap)
    w_frac = torch.clamp(torch.exp(2.0 * (E - Ev)), 0.0, 1.0)
    # fallback where the plateaus cannot be localized: the voicing bit
    # eroded by one frame on each side
    v_er = erode1d(vmask.to(torch.float32), 1)
    w_fin = torch.where(ok, w_frac, v_er)[..., 0]  # (B, nf)
    # the w-based placement owns only frames within ap.gate_edge_radius of a
    # voicing edge; beyond, the gate follows the voicing bit
    vb = voiced_f > 0.5
    edge = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, 1:] != vb[:, :-1]], dim=1)
    near_edge = dilate1d(edge.to(torch.float32), ap.gate_edge_radius)
    w_fin = torch.where(near_edge > 0.5, w_fin, voiced_f)
    step = (per_sample(w_fin) > ap.gate_theta).to(torch.float32)
    # within one frame of the voiced region only
    step = step * torch.clamp(2.0 * per_sample(dilate1d(voiced_f, 1)), 0.0, 1.0)
    # triangular ~5 ms ramp (two box filters) centred on the crossing
    R = max(hop // 2, 2)
    c = torch.cumsum(torch.nn.functional.pad(step[:, None], (R, R), mode="replicate")[:, 0], dim=-1)
    box = (c[:, R + R :] - c[:, : -R - R]) / (2 * R)
    h = R // 2
    c2 = torch.cumsum(torch.nn.functional.pad(box[:, None], (h, h), mode="replicate")[:, 0], dim=-1)
    gate_s = (c2[:, h + h :] - c2[:, : -R // 2 - R // 2]) / (2 * h)
    harm = gate_s * torch.sum(amp_s * torch.cos(phase[..., None] * k + phi_s), dim=-1)

    # ---- stochastic part -------------------------------------------------- #
    # per-band noise std from the envelope under the analyzer's convention:
    # voiced frames key on the continuous f0, unvoiced on 500 Hz
    f0_a = torch.where(voiced_f > 0.5, f0, DEFAULT_UNVOICED_F0)
    sigma = A * torch.sqrt(nm_bins) * NOISE_CAL / torch.sqrt(f0_a * CAL * dftlen / fs)[..., None]
    # short synthesis frames (2·hop) so a loud frame's noise cannot smear
    # into quiet neighbours; one noise STFT serves the whole batch
    nframe = 2 * hop
    window = hann_window(nframe, device=dev)
    Nspec = stft(noise[None], nframe, hop, dftlen, window)[:, :nf]  # (1, nf, bins)
    # phase-only: each bin's magnitude pinned to its expectation
    mag = torch.sqrt(torch.sum(window * window))
    Nspec = mag * Nspec / torch.clamp(torch.abs(Nspec), min=1e-12)
    noise_wav = istft(Nspec * sigma, nframe, hop, n, window)

    # pulse-synchronous amplitude modulation of the noise in voiced regions,
    # power-normalized
    voiced_s = per_sample(voiced_f)
    g = 1.0 + NOISE_MOD * voiced_s * torch.cos(phase)
    g = g / torch.sqrt(1.0 + 0.5 * (NOISE_MOD * voiced_s) ** 2)
    return harm + noise_wav * g


def pml_closed_loop_core(
    lf0: torch.Tensor,
    spec_w: torch.Tensor,
    nm_w: torch.Tensor,
    noise: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    spec_size: int,
    nm_size: int,
    f0_min: float,
    f0_max: float,
    envelope: str = "harmonic",
    env_time_smooth: int = 1,
    iters: int = 1,
    ap: AnalysisParams = DEFAULT_ANALYSIS,
) -> torch.Tensor:
    """Closed-loop (analysis-by-synthesis) PML rendering, ``(B, nf·hop)``.

    The roundtrip R = analyze∘synthesize is not the identity, and its error
    repeats across roundtrips; each pass renders, re-analyzes, and corrects
    the spec stream by the clamped error on frames where both analyses agree
    on voicing: full strength away from voicing flips, damped
    (``ap.cl_near_alpha``, ``ap.cl_near_clamp``) within
    ``ap.cl_boundary_radius`` of one; later passes correct interior frames
    only. ``noise`` is shared by every render."""
    syn_kw = dict(fs=fs, hop=hop, dftlen=dftlen, f0_min=f0_min, f0_max=f0_max,
                  env_halfw=env_halfw_for(envelope), env_tri_radius=env_time_smooth, ap=ap)
    ana_kw = dict(fs=fs, hop=hop, dftlen=dftlen, spec_size=spec_size, nm_size=nm_size,
                  f0_min=f0_min, f0_max=f0_max, envelope=envelope,
                  env_time_smooth=env_time_smooth, ap=ap)
    dev = lf0.device
    v1 = _vuv_from_nm(nm_w, ap)  # (B, nf)
    flip = torch.cat([torch.zeros_like(v1[:, :1]), torch.abs(torch.diff(v1, dim=1))], dim=1)
    near = dilate1d(flip, ap.cl_boundary_radius)
    # near-boundary damping per band: the low (voicing-read) bands keep
    # ap.cl_near_alpha, the bands above may correct harder
    lo_b = max(int(spec_size * ap.cl_it2_freeze_frac), 1)
    na_band = torch.cat([
        torch.full((lo_b,), ap.cl_near_alpha, device=dev),
        torch.full((spec_size - lo_b,), ap.cl_near_alpha_hi, device=dev),
    ])
    alpha = ap.cl_full_alpha - (ap.cl_full_alpha - na_band) * near[..., None]
    clamp = (ap.cl_clamp - (ap.cl_clamp - ap.cl_near_clamp) * near)[..., None]

    spec_c, nm_c = spec_w, nm_w
    for it in range(iters):
        wav = pml_synthesize_amp_core(lf0, spec_c, nm_c, noise, **syn_kw)
        feats2, _ = pml_analyze_core(wav, **ana_kw)
        spec2 = feats2[..., 1 : 1 + spec_size]
        nm2 = feats2[..., 1 + spec_size :]
        v2 = _vuv_from_nm(nm2, ap)
        same = (v1 == v2).to(torch.float32)[..., None]
        if it == 0:
            a_it, c_it = alpha, clamp
        else:
            # later passes: interior frames only, tighter clamp, and damped
            # where the re-analysis low-band noise mask sits within 0.15 of
            # the voicing threshold; the low spec bands stay frozen
            low2 = torch.mean(_vuv_low_bands(nm2, ap), dim=-1)
            marg = torch.clamp(torch.abs(low2 - ap.vuv_threshold) / 0.15, 0.0, 1.0)[..., None]
            far = erode1d(1.0 - near, ap.cl_boundary_radius)
            a_it = ap.cl_full_alpha * far[..., None] * marg
            lo = max(int(spec_size * ap.cl_it2_freeze_frac), 1)
            a_it = a_it * torch.cat([torch.zeros(lo, device=dev),
                                     torch.ones(spec_size - lo, device=dev)])
            c_it = torch.tensor(0.8, device=dev)
        e = torch.minimum(torch.maximum(spec2 - spec_w, -c_it), c_it) * a_it * same
        spec_c = spec_c - e
        if ap.cl_nm_alpha > 0.0:
            # interior-only nm pre-compensation
            a_nm = (ap.cl_nm_alpha * (1.0 - near))[..., None] * same
            en = torch.clamp(nm2 - nm_w, -ap.cl_nm_clamp, ap.cl_nm_clamp) * a_nm
            nm_c = torch.clamp(nm_c - en, 0.0, 1.0)
    return pml_synthesize_amp_core(lf0, spec_c, nm_c, noise, **syn_kw)


@register
class PMLVocoder(Vocoder):
    """PML-equivalent vocoder (see module docstring)."""

    kind = "pml"

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        check_envelope(self.cfg.envelope)

    def _noise(self, n: int, seed: int, device) -> torch.Tensor:
        """The ``(n,)`` standard-normal draw of the stochastic component
        (tests replace it with the JAX package's draw)."""
        return seeded_noise(n, seed, device)

    def _analyze_stack(self, stack: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            feats, _ = pml_analyze_core(torch.as_tensor(stack, device=self.device),
                                        frame_len=self.cfg.frame_samples, **analysis_kw(self.cfg))
        return feats.cpu().numpy()

    def _pad_feats(self, feats: np.ndarray, nf_pad: int) -> np.ndarray:
        """Pad (frames, F) features to ``nf_pad`` frames by replicating the
        last real frame: the closed loop re-analyzes the padded render, and
        an analysis-consistent tail keeps the last real frames' corrections
        unbiased (the rendered tail is cut off by the caller)."""
        nf = feats.shape[0]
        fp = np.zeros((nf_pad, feats.shape[1]), np.float32)
        fp[:nf] = feats
        if nf:
            fp[nf:] = feats[-1]
        else:
            fp[:, 0] = np.log(100.0)
            fp[:, 1 + self.cfg.spec_size :] = 1.0
            fp[:, 1 : 1 + self.cfg.spec_size] = -18.0
        return fp

    def synthesize_stacked(self, fp: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The tensor core (see ``Vocoder.synthesize_stacked``): "te"
        features through ``pml_synthesize_core``; the others through the
        closed loop when configured, else the open-loop amplitude core."""
        c = self.cfg
        lf0, spec, nm = fp[..., 0], fp[..., 1 : 1 + c.spec_size], fp[..., 1 + c.spec_size :]
        if c.envelope == "te":
            return pml_synthesize_core(lf0, spec, nm, noise, fs=c.fs, hop=c.shift_samples,
                                       frame_len=c.frame_samples, dftlen=c.dftlen,
                                       f0_min=c.f0_min, f0_max=c.f0_max)
        if c.closed_loop > 0:
            return pml_closed_loop_core(lf0, spec, nm, noise, iters=c.closed_loop,
                                        **analysis_kw(c))
        return pml_synthesize_amp_core(
            lf0, spec, nm, noise, fs=c.fs, hop=c.shift_samples, dftlen=c.dftlen,
            f0_min=c.f0_min, f0_max=c.f0_max, env_halfw=env_halfw_for(c.envelope),
            env_tri_radius=c.env_time_smooth, ap=c.analysis,
        )

    def _render(self, fp: np.ndarray, seed: int) -> np.ndarray:
        """(B, nf_pad, F) padded features → (B, nf_pad·hop) waveforms."""
        noise = self._noise(fp.shape[1] * self.cfg.shift_samples, seed, self.device)
        with torch.no_grad():
            wav = self.synthesize_stacked(torch.as_tensor(fp, device=self.device), noise)
        return wav.cpu().numpy()

    def synthesize(self, feats: np.ndarray, seed: int = 0) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        nf = feats.shape[0]
        if nf == 0:
            return np.zeros((0,), np.float32)
        nf_pad = -(-nf // FRAME_MULTIPLE) * FRAME_MULTIPLE
        return self._render(self._pad_feats(feats, nf_pad)[None], seed)[0, : nf * self.cfg.shift_samples]

    def synthesize_batch(self, feats_list, seed: int = 0, chunk: int = 4) -> list:
        """One batched call per chunk of utterances, all padded to the
        chunk's frame bound. Every utterance draws the same noise sequence,
        exactly as repeated ``synthesize(f, seed=seed)`` calls would."""
        return chunked_synthesize_batch(
            feats_list, chunk, FRAME_MULTIPLE, self.cfg.shift_samples,
            lambda batch, nf_pad: np.stack([self._pad_feats(f, nf_pad) for f in batch]),
            lambda fp: self._render(fp, seed),
        )

    def f0_vuv(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """f0 from the lf0 stream; voicing from the shared low-band
        noise-mask rule (the same ``AnalysisParams`` as the cores' gates)."""
        lf0 = self.stream(feats, "f0")[..., 0]
        nm = self.stream(feats, "nm")
        ap = self.cfg.analysis
        vuv = (_vuv_low_bands(nm, ap).mean(axis=-1) < ap.vuv_threshold).astype(np.float32)
        return np.exp(lf0), vuv

    def f0_vuv_pred(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Voicing for MODEL-PREDICTED tracks under the prediction-side rule
        (``VocoderConfig.vuv_pred_low_frac`` / ``vuv_pred_threshold``; None =
        the analysis rule)."""
        c = self.cfg
        if c.vuv_pred_low_frac is None and c.vuv_pred_threshold is None:
            return self.f0_vuv(feats)
        ap = c.analysis
        frac = c.vuv_pred_low_frac if c.vuv_pred_low_frac is not None else ap.vuv_low_frac
        th = c.vuv_pred_threshold if c.vuv_pred_threshold is not None else ap.vuv_threshold
        nm = self.stream(feats, "nm")
        k = max(int(nm.shape[-1] * frac), 1)
        vuv = (nm[..., :k].mean(axis=-1) < th).astype(np.float32)
        return np.exp(self.stream(feats, "f0")[..., 0]), vuv
