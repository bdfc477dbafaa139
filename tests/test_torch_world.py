"""The port's WORLD vocoder against the JAX package, on the CPU.

``clean_vuv`` and the voicing decision (host numpy, bit for bit), analysis
(``world_analyze_core``), open- and closed-loop synthesis and
``WorldVocoder.synthesize_batch``, each against the JAX function on the
same inputs. As in ``tests/test_torch_vocoder.py``: the noise the JAX cores
draw inside jit is drawn outside with the same key and handed to the port,
the signals are numpy-made with clearly voiced and clearly unvoiced runs
(their voicing decisions sit away from thresholds), and utterances stay at
128 frames (the harmonic phase is a float32 cumulative sum, taken in
another order by XLA and torch).

Tolerances, f32: analysis lf0 1e-5, spec 2e-3 nats, bap 1e-2 (ratios of
inter-harmonic readings near the FFT's f32 rounding floor in weak bands),
vuv identical; the golden at ``tests/test_golden.py``'s tolerances;
waveforms 1e-3 (open loop) and 2e-3 (closed loop) of the largest sample;
``synthesize_batch`` as its test states.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder
from percivaltts_tpu.vocoders import world as jw
from percivaltts_tpu_torch.config import VocoderConfig
from percivaltts_tpu_torch.vocoders import get_vocoder
from percivaltts_tpu_torch.vocoders import world as tw
from percivaltts_tpu_torch.vocoders.world import WorldVocoder
from test_torch_dsp import voiced_unvoiced_signal
from test_torch_vocoder import jax_noise

S, M = 33, 17  # the golden's band counts
CORE = dict(fs=16000, hop=80, dftlen=1024, f0_min=60.0, f0_max=400.0)
ANA = dict(CORE, spec_size=S, nm_size=M, envelope="harmonic", env_time_smooth=1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "world_features_d4c_gd.npz")


def _jax_streams(f):
    return tuple(jnp.asarray(a) for a in (f[:, 0], f[:, 1], f[:, 2 : 2 + S], f[:, 2 + S :]))


def _streams(f):
    t = torch.from_numpy(np.array(f, np.float32))
    return t[..., 0], t[..., 1], t[..., 2 : 2 + S], t[..., 2 + S :]


@pytest.fixture(scope="module")
def jax_features():
    """Two synthetic signals and the JAX package's WORLD features of each."""
    wavs = np.stack([voiced_unvoiced_signal(2), voiced_unvoiced_signal(6)])
    return wavs, [np.asarray(jw.world_analyze_core(jnp.asarray(w), **ANA)) for w in wavs]


def _soft_tracks():
    """Soft (model-like) voicing tracks: random ones, and the borderline
    cases of ``tests/test_vocoder_variants.py::test_world_clean_vuv_borderline_track``."""
    rng = np.random.default_rng(5)
    tracks = [rng.random(n).astype(np.float32) for n in (1, 2, 3, 7, 50, 300)]
    tracks += [np.clip(np.repeat(rng.random(40), rng.integers(1, 6, 40)) + rng.normal(0, 0.1, 1), 0, 1)
               .astype(np.float32) for _ in range(5)]
    b = (rng.random(300) > 0.5).astype(np.float32)
    b[100:120], b[150], b[151:160] = 1.0, 1.0, 0.0
    d = np.where(np.arange(200) % 2 == 0, 0.45, 0.55).astype(np.float32)
    ramp = np.concatenate([np.full(80, 0.1), np.linspace(0.1, 0.9, 5), np.full(80, 0.9)])
    v = ramp.astype(np.float32) + rng.normal(0, 0.02, 165).astype(np.float32)
    noisy = np.where(np.arange(400) < 200, 0.42, 0.58).astype(np.float32)
    noisy = noisy + rng.normal(0, 0.06, 400).astype(np.float32)
    t = np.arange(600)
    soft = (0.5 + 0.08 * np.sin(2 * np.pi * t / 120)).astype(np.float32)
    return tracks + [b, d, v, noisy, soft, np.zeros(0, np.float32)]


def test_clean_vuv_equals_the_original():
    tracks = _soft_tracks()
    for v in tracks:
        got, want = tw.clean_vuv(v), jw.clean_vuv(v)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    stack = np.stack([tracks[-6], np.pad(tracks[-5], (0, 100))])  # (B, T): a binary and a soft row
    np.testing.assert_array_equal(tw.clean_vuv(stack), jw.clean_vuv(stack))
    assert tw.VUV_MIN_RUN == jw.VUV_MIN_RUN


def _predicted_features():
    """(T, F) features with a soft vuv stream releasing early and the low
    bap bands carrying the true release, a binary copy, and both stacked
    (``tests/test_vocoder_variants.py::test_world_vuv_rule_bap``'s)."""
    S_, NM = 9, 5
    feats = np.zeros((100, 2 + S_ + NM), np.float32)
    feats[:, 0] = np.log(140.0)
    feats[:, 1] = 0.1
    feats[20:56, 1] = 0.9
    feats[56:60, 1] = 0.35
    feats[:, 2 : 2 + S_] = -8.0
    feats[:, 2 + S_ :] = 0.95
    feats[20:60, 2 + S_ : 2 + S_ + 3] = 0.2
    fb = feats.copy()
    fb[:, 1] = (fb[:, 1] > 0.5).astype(np.float32)
    return [feats, fb, np.stack([fb, feats])], dict(spec_size=S_, nm_size=NM)


@pytest.mark.parametrize("rule", ["stream", "bap"])
def test_voicing_decision_matches_jax(rule):
    feats_list, sizes = _predicted_features()
    mine = get_vocoder(VocoderConfig(kind="world", vuv_rule=rule, **sizes), device="cpu")
    theirs = jax_get_vocoder(JaxVocoderConfig(kind="world", vuv_rule=rule, **sizes))
    for f in feats_list:
        np.testing.assert_array_equal(mine._decide_vuv(f), theirs._decide_vuv(f))
        for fn in ("f0_vuv", "f0_vuv_pred"):
            for g, w in zip(getattr(mine, fn)(f), getattr(theirs, fn)(f)):
                np.testing.assert_array_equal(g, w)
    # the bap rule ends voicing where the bap stream says, the stream rule early
    assert np.flatnonzero(mine.f0_vuv(feats_list[0])[1]).max() == (59 if rule == "bap" else 55)
    bad = get_vocoder(VocoderConfig(kind="world", vuv_rule="nope", **sizes), device="cpu")
    with pytest.raises(ValueError, match="vuv_rule"):
        bad.f0_vuv(feats_list[0])


def test_analysis_matches_jax(jax_features):
    wavs, want = jax_features
    got = tw.world_analyze_core(torch.from_numpy(wavs), **ANA).numpy()
    assert got.shape == (2, 128, 2 + S + M)
    for b in range(2):
        g, w = got[b], want[b]
        np.testing.assert_array_equal(g[:, 1], w[:, 1])
        assert 40 < w[:, 1].sum() < 100
        np.testing.assert_allclose(g[:, 0], w[:, 0], atol=1e-5)
        np.testing.assert_allclose(g[:, 2 : 2 + S], w[:, 2 : 2 + S], atol=2e-3)
        np.testing.assert_allclose(g[:, 2 + S :], w[:, 2 + S :], atol=1e-2)
        assert np.all(g[w[:, 1] < 0.5, 2 + S :] == 1.0)  # unvoiced: fully aperiodic


def test_analysis_peak_valley_bap_matches_jax(jax_features):
    """``AnalysisParams.bap_method="peak_valley"``: the eroded peak/valley
    noise mask as the bap stream; the other streams as the default's."""
    wavs, want = jax_features
    cfg = VocoderConfig()
    ap = dataclasses.replace(cfg.analysis, bap_method="peak_valley")
    got = tw.world_analyze_core(torch.from_numpy(wavs[:1]), **ANA, ap=ap)[0].numpy()
    jcfg = JaxVocoderConfig()
    jap = dataclasses.replace(jcfg.analysis, bap_method="peak_valley")
    w = np.asarray(jw.world_analyze_core(jnp.asarray(wavs[0]), **ANA, ap=jap))
    np.testing.assert_array_equal(got[:, 1], w[:, 1])
    np.testing.assert_allclose(got[:, 2 + S :], w[:, 2 + S :], atol=1e-2)
    np.testing.assert_allclose(got[:, : 2 + S], want[0][:, : 2 + S], atol=2e-3)
    with pytest.raises(ValueError, match="bap_method"):
        tw.world_analyze_core(torch.from_numpy(wavs[:1]), **ANA,
                              ap=dataclasses.replace(ap, bap_method="nope"))


def test_analysis_matches_the_golden():
    """``tests/test_golden.py::test_world_features_match_golden_d4c_gd``'s
    tolerances (lf0 1e-3, the rest 5e-3) on every stream and band but the
    top three spec bands, which take 0.03 nats, as the PML harmonic
    golden's (``tests/test_torch_vocoder.py::test_analysis_matches_the_harmonic_golden``):
    the noise-like smoothing gate reads the golden signal's f32-rounding
    valleys there. JAX misses 5e-3 there by itself: the same analysis run
    without jit reads 0.0158 off the golden (the port: 0.0167)."""
    z = np.load(GOLDEN)
    feats = get_vocoder(VocoderConfig(kind="world", spec_size=S, nm_size=M), device="cpu").analyze(z["wav"])
    want = z["feats"]
    assert feats.shape == want.shape
    top = slice(2 + S - 3, 2 + S)
    np.testing.assert_allclose(feats[:, 0], want[:, 0], atol=1e-3)
    np.testing.assert_allclose(feats[:, 1 : top.start], want[:, 1 : top.start], atol=5e-3)
    np.testing.assert_allclose(feats[:, top], want[:, top], atol=0.03)
    np.testing.assert_allclose(feats[:, top.stop :], want[:, top.stop :], atol=5e-3)


def test_open_loop_synthesis_matches_jax(jax_features):
    """WORLD renders through PML's amplitude core with the bap stream as the
    noise mask, 1 where the vuv stream is unvoiced."""
    _, feats = jax_features
    f = feats[0]
    n = f.shape[0] * 80
    lf0, vuv, spec, bap = _streams(f[None])
    nm = torch.where(vuv[..., None] > 0.5, bap, 1.0)
    from percivaltts_tpu.vocoders import pml as jp
    from percivaltts_tpu_torch.vocoders import pml as tp

    jl, jv, js, jb = _jax_streams(f)
    want = np.asarray(jp.pml_synthesize_amp_core(jl, js, jnp.where(jv[:, None] > 0.5, jb, 1.0),
                                                 frame_len=400, seed=0, env_halfw=2.0,
                                                 env_tri_radius=1, **CORE))
    got = tp.pml_synthesize_amp_core(lf0, spec, nm, torch.from_numpy(jax_noise(n)), env_halfw=2.0,
                                     env_tri_radius=1, **CORE)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_closed_loop_matches_jax(jax_features):
    """Two correction passes; both packages' first re-analysis must read
    the same voicing before the waveforms are compared."""
    _, feats = jax_features
    f = feats[1]
    n = f.shape[0] * 80
    noise = torch.from_numpy(jax_noise(n))
    want = np.asarray(jw.world_closed_loop_core(*_jax_streams(f), frame_len=400, seed=0, iters=2, **ANA))
    got = tw.world_closed_loop_core(*_streams(f[None]), noise, iters=2, **ANA)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())
    one = tw.world_closed_loop_core(*_streams(f[None]), noise, iters=0, **ANA)[0].numpy()
    assert np.abs(got - one).max() > 1e-2  # the correction passes moved the render


def test_synthesize_batch_matches_jax(jax_features, monkeypatch):
    """The default vocoder (closed loop, 2 passes) through
    ``synthesize_batch``: chunks of 2, the last padded by repetition, each
    padded to 128 frames by replicating its last frame. Tolerance as PML's
    (``tests/test_torch_vocoder.py::test_synthesize_batch_matches_jax``): 1e-2
    of the RMS in RMS and 5e-2 of the largest sample at any sample (a
    re-analysis difference can move the per-sample voicing gate's
    crossing by a sample or two)."""
    _, feats = jax_features
    feats_list = [feats[0], feats[1][:70], feats[0][30:100]]
    cfg = dict(kind="world", spec_size=S, nm_size=M)
    want = jax_get_vocoder(JaxVocoderConfig(**cfg)).synthesize_batch(feats_list, seed=3, chunk=2)
    voc = get_vocoder(VocoderConfig(**cfg), device="cpu")
    monkeypatch.setattr(WorldVocoder, "_noise", lambda self, n, seed, device: torch.from_numpy(jax_noise(n, seed)))
    got = voc.synthesize_batch(feats_list, seed=3, chunk=2)
    assert [len(g) for g in got] == [f.shape[0] * 80 for f in feats_list]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-2 * np.sqrt(np.mean(w**2))
        np.testing.assert_allclose(g, w, atol=5e-2 * np.abs(w).max())
    # alone, the utterance renders as in its chunk
    np.testing.assert_allclose(voc.synthesize(feats_list[1], seed=3), got[1], atol=1e-4)
    # open loop: the same contract
    voc0 = get_vocoder(VocoderConfig(closed_loop=0, **cfg), device="cpu")
    want0 = jax_get_vocoder(JaxVocoderConfig(closed_loop=0, **cfg)).synthesize(feats_list[2], seed=3)
    np.testing.assert_allclose(voc0.synthesize(feats_list[2], seed=3), want0, atol=1e-3 * np.abs(want0).max())


def test_analyze_batch_equals_analyze_and_empty_inputs():
    voc = get_vocoder(VocoderConfig(kind="world", spec_size=S, nm_size=M), device="cpu")
    wavs = [voiced_unvoiced_signal(2, n=6000), voiced_unvoiced_signal(6)]
    for w, b in zip(wavs, voc.analyze_batch(wavs)):
        assert b.shape == (-(-len(w) // 80), 2 + S + M)
        np.testing.assert_allclose(b, voc.analyze(w), atol=1e-5)
    assert voc.synthesize(np.zeros((0, 2 + S + M), np.float32)).shape == (0,)
    with pytest.raises(ValueError):
        voc.analyze(np.zeros((0,), np.float32))
    assert get_vocoder(VocoderConfig(kind="world")).device.type == "cuda"
