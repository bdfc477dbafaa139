"""The port's mel-spectrogram vocoder (config 4) against the JAX package, on
the CPU.

Analysis (``mel_analyze_core``), Griffin-Lim (``mel_synthesize_core``) and
the vocoder's batched calls, each against the JAX function on the same
inputs. The signals have a noise floor under every frame, so no mel band
reads near the 1e-8 log floor, where an f32 FFT rounding difference would
be a large log difference.

Tolerances, f32: log-mel 1e-4 nats; Griffin-Lim after 1 iteration 1e-4 of
the largest sample (FFTs of another library: the phases start from the same
zero-phase spectrum). From the second iteration on, each iteration keeps
only the phase of ``re + 0.99·(re − prev)``, which nearly cancels in bins
where the re-analysis has settled, and the phase of a near-zero vector
carries its rounding whole: one iteration from the JAX package's own state
reads ``re`` within 4e-7 of the JAX re-analysis and renders a spectrum
within 6e-4 of its largest value. After 4 iterations the waveforms differ
by 2.1e-4 of the largest sample (seen), held at 1e-3. After 64 iterations
the momentum (0.99) compounds the FFTs' rounding, and the two
reconstructions are held by what they sound like, not sample by sample: the
log-mels of both waveforms re-analyzed differ by at most 0.05 nats on
average, and each package's copy-synthesis mel-MCD against the source lies
within 0.1 dB of the other's. ``synthesize_batch`` against ``synthesize``
per utterance: 1e-4 (the same padded frames; FFTs and products over
another batch size); ``analyze_batch`` against ``analyze``: bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.vocoders import melspec as jm
from percivaltts_tpu_torch.config import VocoderConfig
from percivaltts_tpu_torch.eval.measures import per_frame_mcd_np
from percivaltts_tpu_torch.vocoders import get_vocoder
from percivaltts_tpu_torch.vocoders import melspec as tm
from test_torch_dsp import voiced_unvoiced_signal

KW = dict(fs=16000, hop=80, frame_len=400, dftlen=1024, mel_size=80)


@pytest.fixture(scope="module")
def signal():
    """1.6 s (320 frames) of a voiced/unvoiced signal and its JAX log-mel."""
    x = voiced_unvoiced_signal(3, n=25600)
    return x, np.asarray(jm.mel_analyze_core(jnp.asarray(x), **KW))


def test_mel_analysis_matches_jax(signal):
    x, want = signal
    got = tm.mel_analyze_core(torch.from_numpy(np.stack([x, x[::-1].copy()])), **KW)
    assert got.shape == (2, 320, 80)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(jm.mel_analyze_core(jnp.asarray(x[::-1].copy()), **KW)), atol=1e-4)
    assert want.min() > -12.0  # no band near the log floor


@pytest.mark.parametrize("iterations,tol", [(1, 1e-4), (4, 1e-3)])
def test_griffin_lim_matches_jax(signal, iterations, tol):
    _, logmel = signal
    want = np.asarray(jm.mel_synthesize_core(jnp.asarray(logmel), iterations=iterations, **KW))
    got = tm.mel_synthesize_core(torch.from_numpy(logmel[None].copy()), iterations=iterations, **KW)
    assert got.shape == (1, logmel.shape[0] * 80)
    np.testing.assert_allclose(got[0].numpy(), want, atol=tol * np.abs(want).max())


def test_griffin_lim_64_iterations_sound_as_jax(signal):
    """The default 64 iterations, held by re-analysis (see the module
    docstring)."""
    _, logmel = signal
    want = np.asarray(jm.mel_synthesize_core(jnp.asarray(logmel), **KW))
    got = tm.mel_synthesize_core(torch.from_numpy(logmel[None].copy()), **KW)[0].numpy()
    assert np.isfinite(got).all()
    re = tm.mel_analyze_core(torch.from_numpy(np.stack([got, want])), **KW).numpy()
    assert np.mean(np.abs(re[0] - re[1])) <= 0.05
    voc = get_vocoder(VocoderConfig(kind="melspec"), device="cpu")
    src = voc.cepstra(logmel)
    mcd = [float(np.mean(per_frame_mcd_np(voc.cepstra(r), src))) for r in re]
    assert abs(mcd[0] - mcd[1]) <= 0.1, mcd
    assert mcd[0] < 10.0, mcd  # a reconstruction, not noise


def test_synthesize_batch_equals_synthesize():
    """Chunks of 2 (the last padded by repetition), log floor padding; as
    ``tests/test_vocoder_variants.py::test_melspec_synthesize_batch_matches_single``."""
    voc = get_vocoder(VocoderConfig(kind="melspec", mel_size=20), device="cpu")
    rng = np.random.default_rng(3)
    feats = [rng.normal(-6.0, 1.0, size=(n, 20)).astype(np.float32) for n in (40, 90, 130)]
    batched = voc.synthesize_batch(feats, chunk=2)
    assert [b.shape for b in batched] == [(n * 80,) for n in (40, 90, 130)]
    for f, b in zip(feats, batched):
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, voc.synthesize(f), atol=1e-4)
    assert voc.synthesize(np.zeros((0, 20), np.float32)).shape == (0,)


def test_synthesize_pads_as_jax(monkeypatch):
    """``synthesize`` of the JAX vocoder and of the port's, both cores cut
    to 1 iteration: the port pads to 128 frames with the -18 log floor as
    the JAX vocoder does (another padding would move the last frames'
    samples); 1e-4 of the largest sample."""
    from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
    from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder

    monkeypatch.setattr(jm, "mel_synthesize_core", functools.partial(jm.mel_synthesize_core, iterations=1))
    monkeypatch.setattr(tm, "mel_synthesize_core", functools.partial(tm.mel_synthesize_core, iterations=1))
    f = np.random.default_rng(4).normal(-5.0, 1.0, size=(70, 20)).astype(np.float32)
    want = jax_get_vocoder(JaxVocoderConfig(kind="melspec", mel_size=20)).synthesize(f)
    got = get_vocoder(VocoderConfig(kind="melspec", mel_size=20), device="cpu").synthesize(f)
    assert got.shape == want.shape == (70 * 80,)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_analyze_batch_equals_analyze():
    voc = get_vocoder(VocoderConfig(kind="melspec"), device="cpu")
    wavs = [voiced_unvoiced_signal(s, n=n) for s, n in ((1, 6000), (2, 10240), (5, 800))]
    batched = voc.analyze_batch(wavs)
    for w, b in zip(wavs, batched):
        assert b.shape == (-(-len(w) // 80), 80)
        np.testing.assert_array_equal(b, voc.analyze(w))


def test_vocoder_builds_on_the_card_by_default_and_reads_no_voicing():
    voc = get_vocoder(VocoderConfig(kind="melspec"))
    assert voc.device.type == "cuda" and voc.feature_size == 80
    assert voc.streams == {"mel": (0, 80)}
    with pytest.raises(NotImplementedError, match="MCD on the mel cepstra"):
        voc.f0_vuv(np.zeros((5, 80), np.float32))
