"""Vocoder protocol + registry.

Counterpart of ``percivaltts_tpu/vocoders/base.py``: per-vocoder feature
sizes, analysis of waveforms into per-frame features, synthesis of features
back to waveforms, and the shared pad/chunk/crop loops behind the batched
calls. The cores are batched torch functions that run on the device of their
inputs; a vocoder holds the device it runs them on (the card by default).
The JAX module's ``dsp_scope`` exists for one TPU runtime's quirk and has no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from percivaltts_tpu_torch.config import VocoderConfig

# utterances are padded to a multiple of this many frames before the cores run
FRAME_MULTIPLE = 128


class Vocoder:
    """Base vocoder: maps waveforms ↔ per-frame feature matrices on
    ``device``."""

    kind: str = "base"

    def __init__(self, cfg: VocoderConfig, device="cuda"):
        if cfg.kind != self.kind:
            cfg = VocoderConfig(**{**cfg.__dict__, "kind": self.kind})
        self.cfg = cfg
        self.device = torch.device(device)

    @property
    def feature_size(self) -> int:
        return self.cfg.feature_size

    @property
    def streams(self) -> Dict[str, Tuple[int, int]]:
        return self.cfg.streams

    def stream(self, feats: np.ndarray, name: str) -> np.ndarray:
        a, b = self.streams[name]
        return feats[..., a:b]

    @staticmethod
    def _check_wav(wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if wav.ndim != 1 or wav.size == 0:
            raise ValueError(f"expected a non-empty 1-D waveform, got shape {wav.shape}")
        return wav

    def analyze(self, wav: np.ndarray) -> np.ndarray:
        """waveform (n,) float32 in [-1, 1] → (frames, feature_size)."""
        return self.analyze_batch([self._check_wav(wav)])[0]

    def analyze_batch(self, wavs) -> list:
        """Analyze several waveforms in one batched call of
        ``_analyze_stack`` on their zero-padded stack (see
        ``stacked_analyze_batch``)."""
        return stacked_analyze_batch([self._check_wav(w) for w in wavs], FRAME_MULTIPLE,
                                     self.cfg.shift_samples, self._analyze_stack)

    def _analyze_stack(self, stack: np.ndarray) -> np.ndarray:
        """(B, n) zero-padded float32 waveforms → (B, ceil(n / hop), F)
        features."""
        raise NotImplementedError

    def synthesize(self, feats: np.ndarray, seed: int = 0) -> np.ndarray:
        """(frames, feature_size) → waveform (frames · shift_samples,).
        ``seed`` keys the stochastic (noise) component."""
        raise NotImplementedError

    def synthesize_batch(self, feats_list, seed: int = 0) -> list:
        """Synthesize several utterances; subclasses may override with one
        batched call per chunk."""
        return [self.synthesize(f, seed=seed) for f in feats_list]

    # -- serving export hooks (eval/export.export_synthesis) -------------- #

    # the in-graph tail of an exported synthesis artifact: None replicates
    # the last real frame (the analysis-consistent tail of PML's and WORLD's
    # ``_pad_feats``); a float fills with that constant (mel's log floor)
    pad_fill: Optional[float] = None

    @property
    def frame_multiple(self) -> int:
        """Frames an utterance is padded to a multiple of before the cores
        run: the granularity of an exported synthesis artifact's bound."""
        return FRAME_MULTIPLE

    def export_preprocess(self, feats: np.ndarray) -> np.ndarray:
        """Host-side preparation of ``(frames, F)`` features before they go
        into an exported synthesis artifact; the identity here (WORLD writes
        its decided voicing into the vuv channel)."""
        return feats

    def _noise(self, n: int, seed: int, device) -> Optional[torch.Tensor]:
        """The ``(n,)`` standard-normal draw of the stochastic component,
        or None for a vocoder without one."""
        return None

    def synthesize_stacked(self, fp: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        """``(B, nf_pad, F)`` features (``nf_pad`` a multiple of
        ``frame_multiple``, the tail padded as ``pad_fill`` says) and the
        ``(nf_pad·hop,)`` draw of ``_noise`` → ``(B, nf_pad·hop)``
        waveforms on the features' device: the tensor core behind
        ``synthesize_batch`` and the graph ``eval/export.export_synthesis``
        traces (no host synchronisation inside)."""
        raise NotImplementedError

    def f0_vuv(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Extract (f0_hz, vuv) tracks for F0-RMSE / VUV-error measures."""
        raise NotImplementedError

    def f0_vuv_pred(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``f0_vuv`` for MODEL-PREDICTED feature tracks; defaults to the
        analysis rule."""
        return self.f0_vuv(feats)

    def cepstra(self, feats: np.ndarray, order: int = 25) -> np.ndarray:
        """MCD-ready cepstra of the spectral stream (``spec``, else ``mel``),
        computed on the vocoder's device. ``order`` defaults to the standard
        mel-cepstral order (c0..c24); ``order=None`` keeps the full band
        resolution."""
        from percivaltts_tpu_torch.eval.measures import log_spec_to_cepstra

        key = "spec" if "spec" in self.streams else "mel"
        spec = torch.as_tensor(np.ascontiguousarray(self.stream(feats, key), np.float32),
                               device=self.device)
        with torch.no_grad():
            return log_spec_to_cepstra(spec, order).cpu().numpy()


def chunked_synthesize_batch(feats_list, chunk, frame_multiple, hop, build, run):
    """Shared pad/chunk/crop loop behind ``synthesize_batch``.

    Splits ``feats_list`` into chunks of ``chunk`` utterances (the last chunk
    padded by repeating its final item, so every call sees one batch size),
    pads each chunk to its frame bound (a multiple of ``frame_multiple``),
    runs one batched call, and crops each waveform back to its true length.
    ``build(batch, nf_pad)`` stacks a chunk's features into the core's
    arguments; ``run(args)`` returns the (chunk, nf_pad·hop) waveforms.
    """
    feats_list = [np.asarray(f, np.float32) for f in feats_list]
    out: list = []
    for c0 in range(0, len(feats_list), chunk):
        batch = list(feats_list[c0 : c0 + chunk])
        nfs = [f.shape[0] for f in batch]
        real = len(batch)
        while len(batch) < chunk:
            batch.append(batch[-1])
            nfs.append(nfs[-1])
        nf_pad = -(-max(nfs) // frame_multiple) * frame_multiple
        wavs = np.asarray(run(build(batch, nf_pad)))
        out.extend(wavs[j, : nfs[j] * hop] for j in range(real))
    return out


def stacked_analyze_batch(wavs, frame_multiple, hop, run):
    """Shared stack/pad/crop loop behind ``analyze_batch``: zero-pad all
    waveforms to the batch's frame bound, run one batched call
    (``run(stack) -> (B, nf_pad, F)`` features), crop on the host."""
    if not wavs:
        return []
    nfs = [int(np.ceil(len(w) / hop)) for w in wavs]
    nf_pad = -(-max(nfs) // frame_multiple) * frame_multiple
    stack = np.zeros((len(wavs), nf_pad * hop), np.float32)
    for i, w in enumerate(wavs):
        stack[i, : len(w)] = np.asarray(w, np.float32)
    feats = np.asarray(run(stack))
    return [feats[i, :n] for i, n in enumerate(nfs)]


_REGISTRY: Dict[str, Type[Vocoder]] = {}


def register(cls: Type[Vocoder]) -> Type[Vocoder]:
    _REGISTRY[cls.kind] = cls
    return cls


def get_vocoder(cfg: VocoderConfig, device="cuda") -> Vocoder:
    """Factory by ``cfg.kind``; the vocoder runs its DSP on ``device``."""
    try:
        cls = _REGISTRY[cfg.kind]
    except KeyError:
        raise ValueError(f"unknown vocoder kind {cfg.kind!r}; known: {sorted(_REGISTRY)}") from None
    return cls(cfg, device)
