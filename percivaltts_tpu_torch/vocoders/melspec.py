"""Mel-spectrogram target variant (config 4 of ``bench.py``).

Counterpart of ``percivaltts_tpu/vocoders/melspec.py`` with ``vmap``
written out as a leading batch axis. Analysis is one batched STFT, the mel
filterbank as one product and a log; synthesis is fast Griffin-Lim (64
iterations, momentum 0.99, zero-phase start) from the pseudo-inverted
filterbank. The JAX package's ``lax.fori_loop`` is a Python loop over
device tensors that never reads a value back to the host. Every framing and
overlap-add goes through ``ops/stft.py``, so on the card each iteration
launches the framing kernel once and the overlap-add kernel twice (the
frames and the window² normaliser).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from percivaltts_tpu_torch.ops.stft import hann_window, istft, stft
from percivaltts_tpu_torch.ops.warp import mel_pinv, mel_weights
from percivaltts_tpu_torch.vocoders.base import (
    FRAME_MULTIPLE,
    Vocoder,
    chunked_synthesize_batch,
    register,
)
from percivaltts_tpu_torch.vocoders.pml import _const

# Griffin-Lim's defaults, the JAX package's
GL_ITERATIONS = 64
GL_MOMENTUM = 0.99
# the log-mel value padded frames take (the log floor of near silence)
LOG_FLOOR = -18.0


def mel_analyze_core(wav: torch.Tensor, fs: int, hop: int, frame_len: int, dftlen: int,
                     mel_size: int) -> torch.Tensor:
    """``(B, n)`` waveforms → ``(B, ceil(n / hop), mel_size)`` log-mel
    magnitudes. The filterbank product runs in float64 and is rounded to
    float32 once, so that an utterance's features do not depend on the
    utterances stacked with it: an f32 GEMM's blocking follows its row
    count, and moves the last bit of a row with it."""
    window = hann_window(frame_len, device=wav.device)
    mag = torch.abs(stft(wav, frame_len, hop, dftlen, window))
    W = _const(mel_weights(mel_size, dftlen, fs), wav.device).double()
    mel = (mag.double() @ W).float()
    return torch.log(torch.clamp(mel, min=1e-8))


def mel_synthesize_core(logmel: torch.Tensor, fs: int, hop: int, frame_len: int, dftlen: int,
                        mel_size: int, iterations: int = GL_ITERATIONS) -> torch.Tensor:
    """Fast Griffin-Lim from ``(B, nf, mels)`` log-mel magnitudes →
    ``(B, nf·hop)`` waveforms: each iteration renders the spectrum,
    re-analyzes it, extrapolates the re-analysis with momentum and keeps its
    phase under the target magnitude."""
    nf = logmel.shape[1]
    n = nf * hop
    dev = logmel.device
    mag = torch.clamp(torch.exp(logmel) @ _const(mel_pinv(mel_size, dftlen, fs), dev), min=1e-8)
    window = hann_window(frame_len, device=dev)
    spec = prev = mag.to(torch.complex64)
    for _ in range(iterations):
        x = istft(spec, frame_len, hop, n, window)
        re = stft(x, frame_len, hop, dftlen, window)[:, :nf]
        acc = re + GL_MOMENTUM * (re - prev)
        spec, prev = mag * (acc / torch.clamp(torch.abs(acc), min=1e-12)), re
    return istft(spec, frame_len, hop, n, window)


@register
class MelSpecVocoder(Vocoder):
    """Log-mel features analyzed and rendered on ``device``."""

    kind = "melspec"

    def _kw(self) -> dict:
        c = self.cfg
        return dict(fs=c.fs, hop=c.shift_samples, frame_len=c.frame_samples, dftlen=c.dftlen,
                    mel_size=c.mel_size)

    def _analyze_stack(self, stack: np.ndarray) -> np.ndarray:
        """The framing is centred and zero-padded and the filterbank product
        batch-invariant, so an utterance reads the same features alone or
        in a stack."""
        with torch.no_grad():
            return mel_analyze_core(torch.as_tensor(stack, device=self.device),
                                    **self._kw()).cpu().numpy()

    # Griffin-Lim is global: an exported artifact pads with the log floor, as
    # the host pads a chunk, so that the padding is the same part of the result
    pad_fill = LOG_FLOOR

    def synthesize_stacked(self, fp: torch.Tensor, noise=None) -> torch.Tensor:
        """The tensor core (see ``Vocoder.synthesize_stacked``): Griffin-Lim;
        there is no noise."""
        return mel_synthesize_core(fp, **self._kw())

    def _render(self, fp: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.synthesize_stacked(torch.as_tensor(fp, device=self.device)).cpu().numpy()

    def synthesize(self, feats: np.ndarray, seed: int = 0) -> np.ndarray:
        """Pads to a multiple of ``FRAME_MULTIPLE`` frames with the log
        floor (Griffin-Lim is global: the padding is part of the result);
        ``seed`` is unused (no noise)."""
        feats = np.asarray(feats, np.float32)
        nf = feats.shape[0]
        if nf == 0:
            return np.zeros((0,), np.float32)
        nf_pad = -(-nf // FRAME_MULTIPLE) * FRAME_MULTIPLE
        fp = np.full((1, nf_pad, feats.shape[1]), LOG_FLOOR, np.float32)
        fp[0, :nf] = feats
        return self._render(fp)[0, : nf * self.cfg.shift_samples]

    def synthesize_batch(self, feats_list, seed: int = 0, chunk: int = 4) -> list:
        """One batched Griffin-Lim per chunk of utterances, padded with the
        log floor to the chunk's frame bound (the last chunk filled by
        repeating its final utterance)."""
        c = self.cfg

        def build(batch, nf_pad):
            fp = np.full((chunk, nf_pad, c.mel_size), LOG_FLOOR, np.float32)
            for j, f in enumerate(batch):
                fp[j, : f.shape[0]] = f
            return fp

        return chunked_synthesize_batch(feats_list, chunk, FRAME_MULTIPLE, c.shift_samples,
                                        build, self._render)

    def f0_vuv(self, feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError(
            "mel-spectrogram features carry no explicit f0/vuv; use MCD on "
            "the mel cepstra for this vocoder"
        )
