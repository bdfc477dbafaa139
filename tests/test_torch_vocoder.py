"""The port's PML vocoder against the JAX package, on the CPU.

Analysis (``pml_analyze_core``), open-loop and closed-loop synthesis and
``PMLVocoder.synthesize_batch``, each against the JAX function on the same
inputs. The noise the JAX cores draw inside jit
(``jax.random.normal(jax.random.key(seed), (n,))``) is drawn outside jit with
the same key and shape and handed to the port. Inputs are numpy-made signals
with clearly voiced and clearly unvoiced runs, analysed by the JAX package,
so no frame sits on a voicing threshold. The noise-mask estimator bins
resampled FFT bins into coarse bands by frequency, and XLA's fused
arithmetic moves a bin on a band edge by an ulp (JAX's jitted and unjitted
analyses of one of these signals differ by 0.25 in one band of one frame):
the signals' seeds are ones where no bin sits on an edge. Utterances stay at 128 frames:
the harmonic phase is a float32 cumulative sum over the samples, which
XLA-CPU and torch take in different orders, and on long utterances the high
harmonics' phases drift apart by O(1e-2) rad.

Tolerances, f32: analysis lf0 1e-5, spec 2e-3 nats, nm 1e-2 (the noise mask
is a ratio of inter-harmonic valley readings near the FFT's f32 rounding
floor in weak bands), voicing identical; waveforms 1e-3 (open loop) and
2e-3 (closed loop, whose re-analyses carry the analysis tolerances into
clamped corrections) of the largest sample; ``synthesize_batch`` as its
test states.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
from percivaltts_tpu.data import compose as jax_compose
from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder
from percivaltts_tpu.vocoders import pml as jp
from percivaltts_tpu_torch.config import VocoderConfig
from percivaltts_tpu_torch.data import compose
from percivaltts_tpu_torch.vocoders import get_vocoder
from percivaltts_tpu_torch.vocoders import pml as tp
from percivaltts_tpu_torch.vocoders.pml import PMLVocoder
from test_torch_dsp import voiced_unvoiced_signal

S, M = 33, 17  # the harmonic golden's band counts
CORE = dict(fs=16000, hop=80, dftlen=1024, f0_min=60.0, f0_max=400.0)
ANA = dict(CORE, spec_size=S, nm_size=M, envelope="harmonic", env_time_smooth=1)
SYN = dict(CORE, env_halfw=2.0, env_tri_radius=1)
GOLDEN_H = os.path.join(os.path.dirname(__file__), "golden", "pml_features_harmonic.npz")
GOLDEN_CT = os.path.join(os.path.dirname(__file__), "golden", "pml_features_cheaptrick.npz")


def jax_noise(n: int, seed: int = 0) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.key(seed), (n,), jnp.float32))


def _streams(feats):
    t = torch.from_numpy(np.array(feats, np.float32))
    return t[..., 0], t[..., 1 : 1 + S], t[..., 1 + S :]


def _jax_streams(f):
    return jnp.asarray(f[:, 0]), jnp.asarray(f[:, 1 : 1 + S]), jnp.asarray(f[:, 1 + S :])


@pytest.fixture(scope="module")
def jax_features():
    """Two synthetic signals and the JAX package's (features, vuv) of each."""
    wavs = np.stack([voiced_unvoiced_signal(2), voiced_unvoiced_signal(6)])
    out = [jp.pml_analyze_core(jnp.asarray(w), frame_len=400, **ANA) for w in wavs]
    return wavs, [np.asarray(f) for f, _ in out], [np.asarray(v) for _, v in out]


def test_analysis_matches_jax(jax_features):
    wavs, want, want_vuv = jax_features
    got, vuv = tp.pml_analyze_core(torch.from_numpy(wavs), **ANA)
    for b in range(2):
        g = got[b].numpy()
        np.testing.assert_array_equal(vuv[b].numpy(), want_vuv[b])
        assert 40 < want_vuv[b].sum() < 100
        np.testing.assert_allclose(g[:, 0], want[b][:, 0], atol=1e-5)
        np.testing.assert_allclose(g[:, 1 : 1 + S], want[b][:, 1 : 1 + S], atol=2e-3)
        np.testing.assert_allclose(g[:, 1 + S :], want[b][:, 1 + S :], atol=1e-2)


def test_analysis_matches_the_harmonic_golden():
    """``tests/test_golden.py``'s tolerances (lf0 1e-3, the rest 5e-3) on
    every stream and band but the top three spec bands, which take 0.03
    nats. There the golden signal's inter-harmonic valleys are f32 FFT
    rounding noise, the noise-like smoothing gate reads them, and the gate
    multiplies a reading difference by the level gap between neighbouring
    frames (up to 6 nats at a voicing onset). JAX misses 5e-3 there by
    itself: the same analysis run without jit reads 0.0158 off the golden
    (the port: 0.0167)."""
    z = np.load(GOLDEN_H)
    voc = get_vocoder(VocoderConfig(spec_size=S, nm_size=M), device="cpu")
    feats = voc.analyze(z["wav"])
    want = z["feats"]
    assert feats.shape == want.shape
    np.testing.assert_allclose(feats[:, 0], want[:, 0], atol=1e-3)
    np.testing.assert_allclose(feats[:, 1 : S - 2], want[:, 1 : S - 2], atol=5e-3)
    np.testing.assert_allclose(feats[:, S - 2 : S + 1], want[:, S - 2 : S + 1], atol=0.03)
    np.testing.assert_allclose(feats[:, 1 + S :], want[:, 1 + S :], atol=5e-3)


def test_cheaptrick_envelope_matches_jax(jax_features):
    """``envelope="cheaptrick"``: f0-adaptive CheapTrick on voiced frames
    (500 Hz on unvoiced ones), at the harmonic analysis's tolerances; the
    noise mask and voicing do not depend on the envelope."""
    wavs, want_h, want_vuv = jax_features
    kw = dict(ANA, envelope="cheaptrick")
    got, vuv = tp.pml_analyze_core(torch.from_numpy(wavs), **kw)
    for b in range(2):
        want, _ = jp.pml_analyze_core(jnp.asarray(wavs[b]), frame_len=400, **kw)
        want, g = np.asarray(want), got[b].numpy()
        np.testing.assert_array_equal(vuv[b].numpy(), want_vuv[b])
        np.testing.assert_allclose(g[:, 0], want[:, 0], atol=1e-5)
        np.testing.assert_allclose(g[:, 1 : 1 + S], want[:, 1 : 1 + S], atol=2e-3)
        np.testing.assert_allclose(g[:, 1 + S :], want_h[b][:, 1 + S :], atol=1e-2)
        # voiced frames read another envelope than the harmonic one
        voiced = want_vuv[b] > 0.5
        assert np.abs(g[voiced, 1 : 1 + S] - want_h[b][voiced, 1 : 1 + S]).max() > 0.1


def test_analysis_matches_the_cheaptrick_golden():
    """``tests/test_golden.py::test_pml_features_match_golden_cheaptrick``'s
    tolerances (lf0 1e-3, the rest 5e-3) on every stream and band but the
    top three spec bands, which take 0.11 nats: there, as in the harmonic
    golden's case, the smoothing gate multiplies a reading of f32 rounding
    noise by the level gap between frames, and CheapTrick's voiced frames
    widen that gap. JAX misses 5e-3 there by itself: the same analysis run
    without jit reads 0.096 off the golden (the port: 0.102, and 0.020 off
    JAX's unjitted analysis; too slow, 38 s, to run here)."""
    z = np.load(GOLDEN_CT)
    voc = get_vocoder(VocoderConfig(spec_size=S, nm_size=M, envelope="cheaptrick"), device="cpu")
    feats = voc.analyze(z["wav"])
    want = z["feats"]
    assert feats.shape == want.shape
    np.testing.assert_allclose(feats[:, 0], want[:, 0], atol=1e-3)
    np.testing.assert_allclose(feats[:, 1 : S - 2], want[:, 1 : S - 2], atol=5e-3)
    np.testing.assert_allclose(feats[:, S - 2 : S + 1], want[:, S - 2 : S + 1], atol=0.11)
    np.testing.assert_allclose(feats[:, 1 + S :], want[:, 1 + S :], atol=5e-3)


def test_open_loop_synthesis_matches_jax(jax_features):
    _, feats, _ = jax_features
    n = feats[0].shape[0] * 80
    want = np.asarray(jp.pml_synthesize_amp_core(*_jax_streams(feats[0]), frame_len=400, seed=0, **SYN))
    got = tp.pml_synthesize_amp_core(*_streams(feats[0][None]), torch.from_numpy(jax_noise(n)), **SYN)
    assert got.shape == (1, n)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-3 * np.abs(want).max())


def test_closed_loop_matches_jax(jax_features):
    """Two correction passes. The first render's re-analysis must read the
    same voicing in both packages before the waveforms are compared."""
    _, feats, _ = jax_features
    f = feats[1]
    n = f.shape[0] * 80
    noise = torch.from_numpy(jax_noise(n))
    lf0, spec, nm = _streams(f[None])
    render = tp.pml_synthesize_amp_core(lf0, spec, nm, noise, **SYN)
    _, v2 = tp.pml_analyze_core(render, **ANA)
    j_render = jp.pml_synthesize_amp_core(*_jax_streams(f), frame_len=400, seed=0, **SYN)
    _, j_v2 = jp.pml_analyze_core(j_render, frame_len=400, **ANA)
    np.testing.assert_array_equal(v2[0].numpy(), np.asarray(j_v2))

    want = np.asarray(jp.pml_closed_loop_core(*_jax_streams(f), frame_len=400, seed=0, iters=2, **ANA))
    got = tp.pml_closed_loop_core(lf0, spec, nm, noise, iters=2, **ANA)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())
    # the correction passes moved the render
    assert np.abs(got - render[0].numpy()).max() > 1e-2


def test_synthesize_batch_matches_jax(jax_features, monkeypatch):
    """The default vocoder (closed loop, 2 passes) through
    ``synthesize_batch``: chunks of 2, the last padded by repetition, each
    padded to 128 frames by replicating its last frame, every waveform cut
    to nf·80 samples. Tolerance: 1e-2 of the RMS in RMS, and 5e-2 of the
    largest sample at any sample. The re-analyses differ by up to 6e-3 nats
    in spec, which can move the sample where the per-sample voicing gate
    crosses its threshold by one or two samples; the gate's ramp then
    differs by 1/80 of the harmonic amplitude per sample moved (seen: 2.0e-2
    of the largest sample near a voicing onset, 4.1e-3 in RMS)."""
    _, feats, _ = jax_features
    feats_list = [feats[0], feats[1][:70], feats[0][30:100]]
    cfg = dict(spec_size=S, nm_size=M)
    want = jax_get_vocoder(JaxVocoderConfig(**cfg)).synthesize_batch(feats_list, seed=3, chunk=2)
    voc = get_vocoder(VocoderConfig(**cfg), device="cpu")
    monkeypatch.setattr(PMLVocoder, "_noise", lambda self, n, seed, device: torch.from_numpy(jax_noise(n, seed)))
    got = voc.synthesize_batch(feats_list, seed=3, chunk=2)
    assert [len(g) for g in got] == [f.shape[0] * 80 for f in feats_list]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-2 * np.sqrt(np.mean(w**2))
        np.testing.assert_allclose(g, w, atol=5e-2 * np.abs(w).max())
    # alone, the utterance renders as in its chunk (to the rounding of
    # products and FFTs over another batch size)
    one = voc.synthesize(feats_list[1], seed=3)
    np.testing.assert_allclose(one, got[1], atol=1e-4)


def test_noise_draw_is_seeded_and_shared():
    voc = get_vocoder(VocoderConfig(spec_size=S, nm_size=M), device="cpu")
    a, b = voc._noise(800, 5, "cpu"), voc._noise(800, 5, "cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, voc._noise(800, 6, "cpu"))


def test_voicing_rules_match_jax(jax_features):
    _, feats, _ = jax_features
    cfgs = [dict(), dict(vuv_pred_low_frac=0.65, vuv_pred_threshold=0.6)]
    for kw in cfgs:
        mine = get_vocoder(VocoderConfig(spec_size=S, nm_size=M, **kw), device="cpu")
        theirs = jax_get_vocoder(JaxVocoderConfig(spec_size=S, nm_size=M, **kw))
        for fn in ("f0_vuv", "f0_vuv_pred"):
            for g, w in zip(getattr(mine, fn)(feats[0]), getattr(theirs, fn)(feats[0])):
                np.testing.assert_array_equal(g, w)


def test_unported_vocoders_and_options_raise():
    """An unknown envelope name raises (a held difference: the JAX package
    reads it as "te" in PML and as 500 Hz CheapTrick in WORLD), an unknown
    kind raises, and every kind and envelope builds, on the card unless
    told otherwise ("te" is held against JAX in
    ``tests/test_torch_te.py``)."""
    for kind in ("pml", "world"):
        with pytest.raises(ValueError, match="unknown envelope"):
            get_vocoder(VocoderConfig(kind=kind, envelope="tee"), device="cpu")
    for cfg in (VocoderConfig(kind="world"), VocoderConfig(kind="melspec"),
                VocoderConfig(envelope="cheaptrick"), VocoderConfig(envelope="te"),
                VocoderConfig(kind="world", envelope="te")):
        assert get_vocoder(cfg).device.type == "cuda"
        assert get_vocoder(cfg, device="cpu").cfg == cfg
    with pytest.raises(ValueError, match="unknown vocoder"):
        get_vocoder(dataclasses.replace(VocoderConfig(), kind="nope"), device="cpu")
    voc = get_vocoder(VocoderConfig(spec_size=S, nm_size=M), device="cpu")
    assert voc.synthesize(np.zeros((0, 1 + S + M), np.float32)).shape == (0,)
    with pytest.raises(ValueError):
        voc.analyze(np.zeros((0,), np.float32))


def test_wav_files_read_back_across_packages(tmp_path):
    x = (np.sin(np.arange(1600) / 7.0) * 1.3).astype(np.float32)  # clipped at ±1
    for src, dst in ((compose, jax_compose), (jax_compose, compose)):
        path = str(tmp_path / src.__name__ / "a.wav")
        src.save_wav(path, 16000, x)
        fs, got = dst.load_wav(path)
        fs_ref, want = src.load_wav(path)
        assert fs == fs_ref == 16000
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, np.clip(x, -1, 1), atol=1e-4)  # 16-bit PCM
