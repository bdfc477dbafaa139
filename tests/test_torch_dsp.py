"""The port's vocoder DSP modules against the JAX package, on the CPU.

Framing and overlap-add: the plain twins of the CUDA kernels (TPU kernels
#5, #6) against the Pallas kernels in interpret mode (as
``tests/test_pallas.py`` runs them) and against ``ops/stft.py``'s XLA code,
exactly (0 difference: one copy and at most one multiply per element;
overlap-add sums in the JAX loop's order). The other modules on batches of
numpy-made signals against the JAX functions row by row. Tolerances, f32:

* framing-based spectra (``stft``, ``istft``, CheapTrick): 1e-5 relative to
  the largest value (FFTs of another library, summed in another order);
* f0: 1e-3 Hz (the same lags and parabolic refinements; the difference
  function is a cumulative sum taken in another order);
* the pitch-synchronous readers: the harmonic envelope 1e-2 nats, the noise
  masks 1e-2 (ratios of inter-harmonic valley readings, which sit near the
  f32 rounding floor of the FFT in weak bands).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import aperiodicity as jap
from percivaltts_tpu.ops import cheaptrick as jct
from percivaltts_tpu.ops import f0 as jf0
from percivaltts_tpu.ops import morph as jmorph
from percivaltts_tpu.ops import pallas_kernels as pk
from percivaltts_tpu_torch.config import AnalysisParams
from percivaltts_tpu_torch.ops import aperiodicity as tap
from percivaltts_tpu_torch.ops import cheaptrick as tct
from percivaltts_tpu_torch.ops import f0 as tf0
from percivaltts_tpu_torch.ops import frames_cuda, morph, stft

jstft = importlib.import_module("percivaltts_tpu.ops.stft")

FS, HOP, DFTLEN = 16000, 80, 1024


def voiced_unvoiced_signal(seed: int, n: int = 10240) -> np.ndarray:
    """1.28 s at 16 kHz: two voiced runs (a harmonic series on a wandering
    f0 of 60–160 Hz, faded in and out over 10 ms) between noise, over a
    faint noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    f0 = 110.0 + 50.0 * np.sin(2 * np.pi * 1.3 * t + seed)
    ph = 2 * np.pi * np.cumsum(f0) / FS
    harm = sum(np.cos(k * ph + 0.3 * k * k) / k for k in range(1, 40) if k * f0.max() < 7800)
    voiced = ((t > 0.12) & (t < 0.45)) | ((t > 0.7) & (t < 1.0))
    ramp = np.convolve(voiced.astype(float), np.hanning(161) / np.hanning(161).sum(), "same")
    x = 0.3 * harm * ramp + 0.02 * rng.normal(size=n) * (1 - ramp) + 0.003 * rng.normal(size=n)
    return x.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# --- kernels #5 and #6: the plain twins -------------------------------------


@pytest.mark.parametrize(
    "n,fl,hop",
    [(4000, 400, 80), (1000, 400, 80), (777, 320, 64), (2000, 804, 80), (2000, 800, 80),
     (2000, 160, 80)],
)
def test_frame_window_twin_matches_pallas_and_xla(n, fl, hop):
    rng = np.random.default_rng(n + fl)
    x = rng.normal(size=(3, n)).astype(np.float32)
    w = np.asarray(jstft.hann_window(fl))
    got_w = frames_cuda.frame_window_reference(_t(x), fl, hop, _t(w)).numpy()
    got = frames_cuda.frame_window_reference(_t(x), fl, hop).numpy()
    assert got.shape == (3, -(-n // hop), fl)
    # the Pallas kernel (slow in interpret mode) on one row each way; every
    # batch row against its own XLA framing
    np.testing.assert_array_equal(got_w[0], np.asarray(pk.frame_window(x[0], fl, hop, w, interpret=True)))
    np.testing.assert_array_equal(got[1], np.asarray(pk.frame_window(x[1], fl, hop, None, interpret=True)))
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(jstft.frame_signal(x[b], fl, hop)))
        np.testing.assert_array_equal(got_w[b], np.asarray(jstft.frame_signal(x[b], fl, hop)) * w)


@pytest.mark.parametrize("nf,fl,hop", [(50, 400, 80), (13, 320, 64), (257, 400, 80), (40, 160, 80)])
def test_overlap_add_twin_matches_pallas_and_xla(nf, fl, hop):
    rng = np.random.default_rng(nf + fl)
    frames = rng.normal(size=(2, nf, fl)).astype(np.float32)
    got = frames_cuda.overlap_add_reference(_t(frames), hop, nf * hop).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(pk.overlap_add(frames[b], hop, nf * hop, interpret=True)))
        np.testing.assert_array_equal(got[b], np.asarray(jstft.overlap_add(frames[b], hop, nf * hop)))


def test_wrappers_take_the_twins_on_the_cpu_and_refuse_bad_inputs():
    x = torch.randn(2, 1000)
    before = (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches)
    frames = frames_cuda.frame_window(x, 400, 80)
    torch.testing.assert_close(frames, frames_cuda.frame_window_reference(x, 400, 80), rtol=0, atol=0)
    y = frames_cuda.overlap_add(frames, 80, 1000)
    torch.testing.assert_close(y, frames_cuda.overlap_add_reference(frames, 80, 1000), rtol=0, atol=0)
    assert (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches) == before
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        frames_cuda.frame_window(x[0], 400, 80)
    with pytest.raises(TypeError):
        frames_cuda.frame_window(x.double(), 400, 80)
    with pytest.raises(TypeError):
        frames_cuda.frame_window(x, 400, 80, torch.ones(400, dtype=torch.float64))
    with pytest.raises(ValueError, match="window"):
        frames_cuda.frame_window(x, 400, 80, torch.ones(399))
    with pytest.raises(ValueError, match="out_length"):
        frames_cuda.overlap_add(frames, 80, 13 * 80 + 400)  # past the last frame's reach
    # the uncentred frames of pad=False are plain slices (no kernel, no
    # launch); tests/test_torch_readers.py holds them against JAX
    before = frames_cuda.frame_window.launches
    torch.testing.assert_close(stft.frame_signal(x, 400, 80, pad=False),
                               x.unfold(-1, 400, 80), rtol=0, atol=0)
    assert frames_cuda.frame_window.launches == before


# --- stft / istft / morph / lerp / smoothing --------------------------------


def test_stft_and_istft_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    got = stft.stft(_t(x), 400, HOP, DFTLEN).numpy()
    for b in range(2):
        want = np.asarray(jstft.stft(x[b], 400, HOP, DFTLEN))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5 * np.abs(want).max())
    spec = stft.stft(_t(x), 160, HOP).numpy()
    y = stft.istft(torch.from_numpy(spec), 160, HOP, 3000).numpy()
    for b in range(2):
        want = np.asarray(jstft.istft(jnp.asarray(spec[b]), 160, HOP, 3000))
        np.testing.assert_allclose(y[b], want, rtol=0, atol=1e-5 * np.abs(want).max())
        # the windowed OLA with the window² normaliser inverts the framing
        np.testing.assert_allclose(y[b, 200:-200], x[b, 200:-200], atol=1e-4)
    hann = stft.hann_window(400).numpy()
    np.testing.assert_allclose(hann, np.asarray(jstft.hann_window(400)), atol=1e-7)


def test_morphology_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 4)).astype(np.float32)
    mask = rng.random(size=(3, 20, 1)) < 0.4
    for r in (0, 1, 2, 6, 25):  # 25 > nf: every shift saturates at the edges
        got_d = morph.dilate1d(_t(x), r).numpy()
        got_e = morph.erode1d(_t(x), r).numpy()
        for b in range(3):
            np.testing.assert_array_equal(got_d[b], np.asarray(jmorph.dilate1d(jnp.asarray(x[b]), r)))
            np.testing.assert_array_equal(got_e[b], np.asarray(jmorph.erode1d(jnp.asarray(x[b]), r)))
    filled, reached = morph.fill_from_interior(_t(x), torch.from_numpy(mask), 3)
    for b in range(3):
        wf, wr = jmorph.fill_from_interior(jnp.asarray(x[b]), jnp.asarray(mask[b]), 3)
        np.testing.assert_array_equal(filled[b].numpy(), np.asarray(wf))
        np.testing.assert_array_equal(reached[b].numpy(), np.asarray(wr))


def test_lerp_gather_and_time_smoothing_match_jax():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(2, 30, 1100)).astype(np.float32)
    # positions past both ends, and near n − 1 where the f32 position rounds up
    pos = rng.uniform(-5.0, 1105.0, size=(2, 30, 7)).astype(np.float32)
    pos[..., 0] = 1099.0 - 1e-5
    got = tct.lerp_gather(_t(vals), _t(pos)).numpy()
    vuv = (rng.random(size=(2, 30)) < 0.5).astype(np.float32)
    sm = tct._time_smooth(_t(vals), 3, vuv=_t(vuv)).numpy()
    sm0 = tct._time_smooth(_t(vals), 1).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], np.asarray(jct.lerp_gather(jnp.asarray(vals[b]), jnp.asarray(pos[b]))),
                                   atol=1e-6)
        np.testing.assert_allclose(sm[b], np.asarray(jct._time_smooth(jnp.asarray(vals[b]), 3, vuv=jnp.asarray(vuv[b]))),
                                   atol=1e-6)
        np.testing.assert_allclose(sm0[b], np.asarray(jct._time_smooth(jnp.asarray(vals[b]), 1)), atol=1e-6)
    assert np.isfinite(got).all()


# --- the estimators ---------------------------------------------------------


@pytest.fixture(scope="module")
def analysed():
    """Two synthetic signals and the JAX package's f0 tracks of each."""
    x = np.stack([voiced_unvoiced_signal(0), voiced_unvoiced_signal(2)])
    res = [jf0.estimate_f0(jnp.asarray(row), FS, HOP) for row in x]
    f0 = np.stack([np.asarray(r.f0) for r in res])
    vuv = np.stack([np.asarray(r.vuv) for r in res])
    return x, res, f0, vuv


def test_estimate_f0_matches_jax(analysed):
    x, res, _, _ = analysed
    got = tf0.estimate_f0(_t(x), FS, HOP)
    for b, want in enumerate(res):
        np.testing.assert_array_equal(got.vuv[b].numpy(), np.asarray(want.vuv))
        np.testing.assert_allclose(got.f0[b].numpy(), np.asarray(want.f0), atol=1e-3)
        np.testing.assert_allclose(got.raw_f0[b].numpy(), np.asarray(want.raw_f0), atol=1e-3)
    assert 40 < got.vuv[0].sum() < 100  # both voicing states are present


@pytest.mark.parametrize("f0_kind", ["track", "unvoiced"])
def test_cheaptrick_envelope_matches_jax(analysed, f0_kind):
    x, _, f0, vuv = analysed
    if f0_kind == "unvoiced":
        f0 = np.full_like(f0, tct.DEFAULT_UNVOICED_F0)
    got = tct.cheaptrick_envelope(_t(x), _t(f0), FS, HOP, DFTLEN, time_smooth=1, mirror_mask=_t(vuv)).numpy()
    for b in range(2):
        want = np.asarray(jct.cheaptrick_envelope(jnp.asarray(x[b]), jnp.asarray(f0[b]), FS, HOP, DFTLEN,
                                                  time_smooth=1, mirror_mask=jnp.asarray(vuv[b])))
        np.testing.assert_allclose(got[b], want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["harmonic_envelope", "harmonic_noise_mask", "group_delay_aperiodicity"])
def test_pitch_synchronous_readers_match_jax(analysed, name):
    x, _, f0, vuv = analysed
    size = DFTLEN if name == "harmonic_envelope" else 17
    kw = {"time_smooth": 1} if name == "harmonic_envelope" else {}
    got = getattr(tap, name)(_t(x), _t(f0), FS, HOP, size, 60.0, vuv=_t(vuv), **kw).numpy()
    for b in range(2):
        # called as the JAX package defines them, without jit: XLA's fused
        # arithmetic moves resampled-bin frequencies by an ulp, and a bin on a
        # coarse-band edge of the group-delay statistic changes band (JAX's
        # jitted and unjitted readings of one frame differed by 0.25)
        want = np.asarray(getattr(jap, name)(jnp.asarray(x[b]), jnp.asarray(f0[b]), FS, HOP, size, 60.0,
                                             vuv=jnp.asarray(vuv[b]), **kw))
        assert got[b].shape == want.shape
        np.testing.assert_allclose(got[b], want, atol=1e-2)


def test_non_default_analysis_branches_raise():
    """The boundary-aware readers need the vuv track and raise the JAX
    package's ``ValueError`` without it (they would otherwise read as the
    default, silently); ``psync=False`` needs none. Their values are held
    against JAX in ``tests/test_torch_readers.py``."""
    x, f0 = torch.randn(1, 2000), torch.full((1, 25), 120.0)
    for kw in ({"ps_reflect": True}, {"ps_shift": True}):
        for reader in (tap.harmonic_noise_mask, tap.group_delay_aperiodicity):
            with pytest.raises(ValueError, match="ps_reflect/ps_shift"):
                reader(x, f0, FS, HOP, 17, 60.0, ap=AnalysisParams(**kw))
        tap.harmonic_noise_mask(x, f0, FS, HOP, 17, 60.0, vuv=torch.ones(1, 25),
                                ap=AnalysisParams(**kw))
    nm = tap.harmonic_noise_mask(x, f0, FS, HOP, 17, 60.0, ap=AnalysisParams(psync=False))
    assert nm.shape == (1, 25, 17) and torch.isfinite(nm).all()


def test_psync_frames_read_the_signal_end_as_jax_does():
    """Past ~16k samples the f32 read bound n − 1.001 rounds to n − 1; the
    last frames' reads then stop at the final sample, as the JAX gather's
    clamp makes them (without the clamp they would index past the signal)."""
    n = 20480
    x = np.random.default_rng(3).normal(size=(1, n)).astype(np.float32)
    f0c = np.full((1, n // HOP), 60.0, np.float32)
    got = tap._psync_frames(_t(x), _t(f0c), FS, HOP, n // HOP)[0].numpy()
    want = np.asarray(jap._psync_frames(jnp.asarray(x[0]), jnp.asarray(f0c[0]), FS, HOP, n // HOP))
    np.testing.assert_array_equal(got, want)


def test_nan_positions_read_nan_as_in_jax():
    """A NaN read position (from NaN features) gives NaN, as the JAX gather's
    clamp makes it, not an out-of-bounds index."""
    vals = np.random.default_rng(4).normal(size=(1, 3, 50)).astype(np.float32)
    pos = np.array([[[1.5, np.nan], [np.nan, 48.0], [0.25, 3.0]]], np.float32)
    got = tct.lerp_gather(_t(vals), _t(pos)).numpy()
    want = np.asarray(jct.lerp_gather(jnp.asarray(vals[0]), jnp.asarray(pos[0])))
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(pos[0]))
    np.testing.assert_allclose(got[0], want, atol=1e-6)  # NaN where JAX has NaN
    f0c = np.full((1, 25), np.nan, np.float32)
    seg = tap._psync_frames(_t(np.ones((1, 2000))), _t(f0c), FS, HOP, 25)
    assert torch.isnan(seg).all()
