"""WORLD-style vocoder: f0 + vuv + spectral envelope + band aperiodicity.

Counterpart of ``percivaltts_tpu/vocoders/world.py`` with ``vmap`` written
out as a leading batch axis: the cores take ``(B, n)`` waveforms and
``(B, nf, ·)`` features and run on the device of their inputs. Per-frame
features are

* ``lf0`` — log of the continuous f0 track (YIN, ``ops/f0.py``),
* ``vuv`` — the explicit voicing stream (unlike PML, whose voicing lives in
  the noise mask),
* ``spec`` — the warped log spectral envelope, estimated as PML's
  (``vocoders/pml.py::_envelope_w``: the harmonic envelope or CheapTrick on
  voiced frames, 500 Hz CheapTrick on unvoiced ones; with
  ``envelope="te"``, 500 Hz CheapTrick on every frame, as the JAX package
  reads that name here), then smoothed over noise-like runs,
* ``bap`` — the warped band aperiodicity: the group-delay estimator
  (``AnalysisParams.bap_method="d4c_gd"``, the default) or the peak/valley
  noise mask, eroded, 1 on unvoiced frames.

Synthesis is PML's amplitude-convention core (``pml_synthesize_amp_core``)
with the bap stream as the noise mask, gated to 1 where the vuv stream is
unvoiced; ``world_closed_loop_core`` renders, re-analyzes and corrects the
spec stream ``iters`` times. The noise is an argument of the cores, drawn
as PML draws it. Voicing on model-predicted (soft) tracks is decided on the
host (``WorldVocoder._decide_vuv``, ``clean_vuv``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from percivaltts_tpu_torch.config import AnalysisParams
from percivaltts_tpu_torch.ops.aperiodicity import (
    DEFAULT_ANALYSIS,
    erode5,
    group_delay_aperiodicity,
    harmonic_noise_mask,
)
from percivaltts_tpu_torch.ops.f0 import estimate_f0
from percivaltts_tpu_torch.ops.morph import dilate1d, erode1d
from percivaltts_tpu_torch.vocoders.base import (
    FRAME_MULTIPLE,
    Vocoder,
    chunked_synthesize_batch,
    register,
)
from percivaltts_tpu_torch.vocoders.pml import (
    _envelope_w,
    _smooth_noise_bands,
    analysis_kw,
    check_envelope,
    env_halfw_for,
    pml_synthesize_amp_core,
    seeded_noise,
)

# Minimum voiced/unvoiced run length (frames) that the predicted-voicing
# cleanup enforces (clean_vuv): shorter runs merge into their longer
# neighbour. 3 frames = 15 ms, well under any real phone.
VUV_MIN_RUN = 3


def clean_vuv(v: np.ndarray) -> np.ndarray:
    """Temporal cleanup of a (possibly model-predicted) voicing stream,
    (T,) or (B, T) → binary {0, 1} float32 (a copy of the JAX package's,
    held against it by ``tests/test_torch_world.py``).

    Gated to SOFT tracks (any value strictly inside (0.05, 0.95), i.e. model
    output); binary analysis tracks pass through bit for bit. A median of 3
    removes frame-level dither around the 0.5 threshold, then runs shorter
    than ``VUV_MIN_RUN`` merge into their longer neighbour."""
    v = np.asarray(v, np.float32)
    if v.ndim == 2:
        return np.stack([clean_vuv(row) for row in v])
    n = v.shape[0]
    if n == 0:
        return v.copy()
    if not bool(np.any((v > 0.05) & (v < 0.95))):
        return v.copy()  # binary analysis track: exact no-op
    vp = np.pad(v, 1, mode="edge")
    v = np.median(np.stack([vp[:-2], vp[1:-1], vp[2:]]), axis=0)
    b = (v > 0.5).astype(np.float32)
    # min-run pruning over the run-length encoding (few runs; host-side)
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    lengths = np.diff(np.r_[starts, n])
    runs = list(zip(starts.tolist(), lengths.tolist()))
    changed = True
    while changed and len(runs) > 1:
        changed = False
        for i, (s, ln) in enumerate(runs):
            if ln >= VUV_MIN_RUN:
                continue
            # neighbour lengths (a run at an utterance edge keeps its class
            # unless its single neighbour is longer)
            left = runs[i - 1][1] if i > 0 else -1
            right = runs[i + 1][1] if i + 1 < len(runs) else -1
            if max(left, right) > ln:
                b[s : s + ln] = 1.0 - b[s]
                starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
                lengths = np.diff(np.r_[starts, n])
                runs = list(zip(starts.tolist(), lengths.tolist()))
                changed = True
                break
    return b


def world_analyze_core(
    wav: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    spec_size: int,
    nm_size: int,
    f0_min: float,
    f0_max: float,
    envelope: str = "cheaptrick",
    env_time_smooth: int = 1,
    ap: AnalysisParams = DEFAULT_ANALYSIS,
) -> torch.Tensor:
    """``(B, n)`` waveforms → ``(B, nf, 1 + 1 + spec_size + nm_size)``: lf0,
    vuv, warped log-amplitude envelope, warped band aperiodicity."""
    check_envelope(envelope)
    res = estimate_f0(wav, fs, hop, f0_min, f0_max)
    f0, vuv = res.f0, res.vuv
    f0_floor = min(f0_min, 60.0)
    spec_w = _envelope_w(wav, f0, vuv, fs, hop, dftlen, spec_size, f0_floor, envelope,
                         env_time_smooth, ap)

    nm_raw = harmonic_noise_mask(
        wav, f0, fs, hop, nm_size, f0_floor, valley_smooth=ap.nm_valley_smooth, vuv=vuv, ap=ap
    )
    if ap.bap_method == "d4c_gd":
        # the group-delay statistic for the bap stream; nm_raw still feeds
        # the noise-band smoothing gate below
        bap = erode5(group_delay_aperiodicity(wav, f0, fs, hop, nm_size, f0_floor, vuv=vuv, ap=ap))
    elif ap.bap_method == "peak_valley":
        bap = erode5(nm_raw)
    else:
        raise ValueError(f"unknown AnalysisParams.bap_method: {ap.bap_method}")
    bap = torch.where(vuv[..., None] > 0.5, bap, 1.0)

    # noise-band spectral smoothing, PML's, gated by the raw peak/valley
    # noisiness
    spec_w = _smooth_noise_bands(spec_w, nm_raw)

    lf0 = torch.log(torch.clamp(f0, min=1.0))
    return torch.cat([lf0[..., None], vuv[..., None], spec_w, bap], dim=-1)


def world_closed_loop_core(
    lf0: torch.Tensor,
    vuv: torch.Tensor,
    spec_w: torch.Tensor,
    bap: torch.Tensor,
    noise: torch.Tensor,
    fs: int,
    hop: int,
    dftlen: int,
    spec_size: int,
    nm_size: int,
    f0_min: float,
    f0_max: float,
    envelope: str = "cheaptrick",
    env_time_smooth: int = 1,
    iters: int = 1,
    ap: AnalysisParams = DEFAULT_ANALYSIS,
) -> torch.Tensor:
    """Closed-loop WORLD rendering, ``(B, nf·hop)``: render, re-analyze with
    ``world_analyze_core``, subtract the clamped spec-stream roundtrip error
    where both analyses agree on voicing (damped within
    ``ap.cl_boundary_radius`` frames of a voicing flip; later passes correct
    interior frames only, clamped at 0.8), render again. The explicit vuv
    stream gates the harmonic bank through the noise mask. ``noise`` is
    shared by every render."""
    syn_kw = dict(fs=fs, hop=hop, dftlen=dftlen, f0_min=f0_min, f0_max=f0_max,
                  env_halfw=env_halfw_for(envelope), env_tri_radius=env_time_smooth, ap=ap)
    ana_kw = dict(fs=fs, hop=hop, dftlen=dftlen, spec_size=spec_size, nm_size=nm_size,
                  f0_min=f0_min, f0_max=f0_max, envelope=envelope,
                  env_time_smooth=env_time_smooth, ap=ap)
    nm = torch.where(vuv[..., None] > 0.5, bap, 1.0)
    v1 = (vuv > 0.5).to(torch.float32)
    flip = torch.cat([torch.zeros_like(v1[:, :1]), torch.abs(torch.diff(v1, dim=1))], dim=1)
    near = dilate1d(flip, ap.cl_boundary_radius)
    alpha = (ap.cl_full_alpha - (ap.cl_full_alpha - ap.cl_near_alpha) * near)[..., None]
    clamp = (ap.cl_clamp - (ap.cl_clamp - ap.cl_near_clamp) * near)[..., None]

    spec_c = spec_w
    for it in range(iters):
        wav = pml_synthesize_amp_core(lf0, spec_c, nm, noise, **syn_kw)
        feats2 = world_analyze_core(wav, **ana_kw)
        spec2 = feats2[..., 2 : 2 + spec_size]
        v2 = (feats2[..., 1] > 0.5).to(torch.float32)
        same = (v1 == v2).to(torch.float32)[..., None]
        if it == 0:
            e = torch.minimum(torch.maximum(spec2 - spec_w, -clamp), clamp) * alpha
        else:
            far = erode1d(1.0 - near, ap.cl_boundary_radius)
            e = torch.clamp(spec2 - spec_w, -0.8, 0.8) * (ap.cl_full_alpha * far[..., None])
        spec_c = spec_c - e * same
    return pml_synthesize_amp_core(lf0, spec_c, nm, noise, **syn_kw)


@register
class WorldVocoder(Vocoder):
    """WORLD-equivalent vocoder (see module docstring)."""

    kind = "world"

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        check_envelope(self.cfg.envelope)

    def _noise(self, n: int, seed: int, device) -> torch.Tensor:
        """The ``(n,)`` standard-normal draw of the stochastic component
        (tests replace it with the JAX package's draw)."""
        return seeded_noise(n, seed, device)

    def _decide_vuv(self, feats: np.ndarray) -> np.ndarray:
        """Voicing decision for a feature array (..., F).

        ``vuv_rule="stream"`` (default): the explicit vuv stream through
        ``clean_vuv``. ``vuv_rule="bap"``: on SOFT (model-predicted) tracks,
        voiced where the mean of the lowest ``vuv_bap_bands`` bap bands is
        below ``vuv_bap_threshold``. Binary (analysis) tracks keep the
        explicit stream bit for bit under either rule."""
        c = self.cfg
        v = np.asarray(feats[..., 1], np.float32)
        if c.vuv_rule == "bap":
            soft = (v > 0.05) & (v < 0.95)
            bap = feats[..., 2 + c.spec_size : 2 + c.spec_size + c.nm_size]
            vb = (np.mean(bap[..., : c.vuv_bap_bands], axis=-1)
                  < c.vuv_bap_threshold).astype(np.float32)
            if v.ndim == 1:
                if soft.any():
                    v = vb
            else:  # per-track gating across leading dims
                v = np.where(soft.any(axis=-1)[..., None], vb, v)
        elif c.vuv_rule != "stream":
            raise ValueError(f"unknown VocoderConfig.vuv_rule: {c.vuv_rule!r}")
        return clean_vuv(v)

    def _analyze_stack(self, stack: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            feats = world_analyze_core(torch.as_tensor(stack, device=self.device),
                                       **analysis_kw(self.cfg))
        return feats.cpu().numpy()

    def export_preprocess(self, feats: np.ndarray) -> np.ndarray:
        """A copy of ``feats`` with the decided voicing (``_decide_vuv``: the
        soft-track rules and ``clean_vuv``, host-side numpy) in the vuv
        channel, as ``synthesize`` and an exported artifact take it."""
        out = np.array(feats, np.float32, copy=True)
        out[..., 1] = self._decide_vuv(feats)
        return out

    def _pad_feats(self, feats: np.ndarray, nf_pad: int) -> np.ndarray:
        """``export_preprocess``-ed (frames, F) features padded to
        ``nf_pad`` frames by replicating the last real frame: the closed
        loop re-analyzes the padded render, and a silent tail would bias the
        time-smoothed readings of the last real frames. An empty utterance
        pads with 100 Hz, unvoiced, the log floor and full aperiodicity."""
        c = self.cfg
        nf = feats.shape[0]
        fp = np.empty((nf_pad, feats.shape[1]), np.float32)
        fp[:nf] = self.export_preprocess(feats)
        if nf:
            fp[nf:] = fp[nf - 1]
        else:
            fp[:, 0] = np.log(100.0)
            fp[:, 1] = 0.0
            fp[:, 2 : 2 + c.spec_size] = -18.0
            fp[:, 2 + c.spec_size :] = 1.0
        return fp

    def synthesize_stacked(self, fp: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The tensor core (see ``Vocoder.synthesize_stacked``); the vuv
        channel holds the decided voicing (``export_preprocess``). The
        closed loop when configured, else the open-loop core."""
        c = self.cfg
        lf0, vuv = fp[..., 0].contiguous(), fp[..., 1].contiguous()
        spec = fp[..., 2 : 2 + c.spec_size].contiguous()
        bap = fp[..., 2 + c.spec_size :].contiguous()
        if c.closed_loop > 0:
            return world_closed_loop_core(lf0, vuv, spec, bap, noise, iters=c.closed_loop,
                                          **analysis_kw(c))
        return pml_synthesize_amp_core(
            lf0, spec, torch.where(vuv[..., None] > 0.5, bap, 1.0), noise, fs=c.fs,
            hop=c.shift_samples, dftlen=c.dftlen, f0_min=c.f0_min, f0_max=c.f0_max,
            env_halfw=env_halfw_for(c.envelope), env_tri_radius=c.env_time_smooth,
            ap=c.analysis,
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
        """One batched call per chunk of utterances, each padded to the
        chunk's frame bound by replicating its last frame. Every utterance
        draws the same noise sequence, as repeated ``synthesize(f,
        seed=seed)`` calls would."""
        return chunked_synthesize_batch(
            feats_list, chunk, FRAME_MULTIPLE, self.cfg.shift_samples,
            lambda batch, nf_pad: np.stack([self._pad_feats(f, nf_pad) for f in batch]),
            lambda fp: self._render(fp, seed),
        )

    def f0_vuv(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """f0 from the lf0 stream; voicing by the configured rule
        (``_decide_vuv``; the explicit stream on binary analysis tracks)."""
        return np.exp(feats[..., 0]), self._decide_vuv(feats)
