"""The port's non-default ``AnalysisParams`` readers against the JAX
package, on the CPU: the pitch-synchronous reader's boundary-side
reflection (``ps_reflect``) and window shift (``ps_shift``, with and
without ``ps_shift_snap``; ``ps_shift_nm_only``), the 4·T0 windowed reader
of ``psync=False`` and its module-constant ``VALLEY_8T0`` variant; and
``frame_signal(pad=False)``.

Inputs are two numpy-made signals with voiced and unvoiced runs (so the
vuv tracks flip) analysed by the JAX package's YIN. The JAX readers are
called as the package defines them, without jit (XLA's fused arithmetic
moves a resampled bin across a band edge by an ulp; see
``tests/test_torch_dsp.py``). Tolerances, f32, as for the default reader
there: the harmonic envelope 1e-2 nats, the noise masks and the
group-delay aperiodicity 1e-2; the raw peak/valley readings 1e-4 of their
largest value (the same gathers and FFTs, summed in another order). The
readers' contracts, mirroring ``tests/test_vocoder_variants.py``'s (slow)
convention tests at these sizes: a no-op without voicing flips, far frames
bit-identical with one, a ``ValueError`` without ``vuv``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import aperiodicity as jap
from percivaltts_tpu.ops import f0 as jf0
from percivaltts_tpu_torch.config import AnalysisParams
from percivaltts_tpu_torch.ops import aperiodicity as tap
from percivaltts_tpu_torch.ops import stft
from test_torch_dsp import FS, HOP, voiced_unvoiced_signal

jstft = importlib.import_module("percivaltts_tpu.ops.stft")

SHIFT = AnalysisParams(ps_shift=True)
VARIANTS = {
    "ps_reflect": AnalysisParams(ps_reflect=True),
    "ps_shift": SHIFT,
    "ps_shift_snap": AnalysisParams(ps_shift=True, ps_shift_snap=True),
    "ps_shift_nm_only": AnalysisParams(ps_shift=True, ps_shift_nm_only=True),
    "psync_false": AnalysisParams(psync=False),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def analysed():
    """Two 0.64 s signals with voicing flips and the JAX package's f0 and
    vuv tracks of each."""
    x = np.stack([voiced_unvoiced_signal(0, n=10240), voiced_unvoiced_signal(2, n=10240)])
    res = [jf0.estimate_f0(jnp.asarray(row), FS, HOP) for row in x]
    f0 = np.stack([np.asarray(r.f0) for r in res])
    vuv = np.stack([np.asarray(r.vuv) for r in res])
    assert all(0 < v.sum() < len(v) for v in vuv)
    return x, f0, vuv


def _check_reader(analysed, name, ap, jap_module=jap):
    x, f0, vuv = analysed
    size = 1024 if name == "harmonic_envelope" else 17
    kw = {"time_smooth": 1} if name == "harmonic_envelope" else {}
    got = getattr(tap, name)(_t(x), _t(f0), FS, HOP, size, 60.0, vuv=_t(vuv), ap=ap, **kw).numpy()
    for b in range(2):
        want = np.asarray(getattr(jap_module, name)(
            jnp.asarray(x[b]), jnp.asarray(f0[b]), FS, HOP, size, 60.0,
            vuv=jnp.asarray(vuv[b]), ap=dataclasses.replace(jap.DEFAULT_ANALYSIS, **vars(ap)), **kw))
        assert got[b].shape == want.shape
        np.testing.assert_allclose(got[b], want, atol=1e-2)
    return got


READERS = ("harmonic_envelope", "harmonic_noise_mask", "group_delay_aperiodicity")
# each reader under each variant that changes what it reads: the group-delay
# statistic reads the pitch-synchronous frames whatever ``psync`` says, and
# ``ps_shift_nm_only`` differs from ``ps_shift`` in the envelope alone
CASES = [(v, r) for v in ("ps_reflect", "ps_shift", "ps_shift_snap") for r in READERS]
CASES += [("ps_shift_nm_only", "harmonic_envelope"), ("psync_false", "harmonic_envelope"),
          ("psync_false", "harmonic_noise_mask")]


@pytest.mark.parametrize("variant,name", CASES)
def test_reader_variant_matches_jax(analysed, variant, name):
    _check_reader(analysed, name, VARIANTS[variant])


@pytest.mark.parametrize("name", ["harmonic_envelope", "harmonic_noise_mask"])
def test_valley_8t0_matches_jax(analysed, name, monkeypatch):
    """``psync=False`` with the module constant ``VALLEY_8T0`` set in both
    packages (the JAX reader, unjitted, reads it when called)."""
    monkeypatch.setattr(jap, "VALLEY_8T0", True)
    monkeypatch.setattr(tap, "VALLEY_8T0", True)
    got = _check_reader(analysed, name, VARIANTS["psync_false"])
    monkeypatch.setattr(tap, "VALLEY_8T0", False)
    x, f0, vuv = analysed
    size = 1024 if name == "harmonic_envelope" else 17
    kw = {"time_smooth": 1} if name == "harmonic_envelope" else {}
    off = getattr(tap, name)(_t(x), _t(f0), FS, HOP, size, 60.0, vuv=_t(vuv),
                             ap=VARIANTS["psync_false"], **kw).numpy()
    assert not np.array_equal(got, off)


@pytest.mark.parametrize("variant", ["ps_reflect", "ps_shift", "ps_shift_snap"])
def test_psync_peaks_valleys_variant_matches_jax_and_keeps_its_contract(variant):
    """One 0.64 s voiced signal (f0 140 Hz, harmonics 1–5 and faint noise) read
    by ``_psync_peaks_valleys`` (20 harmonics): against JAX with one vuv
    flip mid-signal, within 1e-4 of the largest reading; a no-op on a
    flip-free vuv; frames farther from the flip than the window's span
    bit-identical to the centred reader, those next to it changed; no
    ``vuv``, a ``ValueError``."""
    ap = VARIANTS[variant]
    rng = np.random.default_rng(2)
    f0 = 140.0
    n = 10240  # the fixture's length: the JAX ops traced there are reused
    t = np.arange(n, dtype=np.float32) / FS
    sig = sum(0.4 / k * np.sin(2 * np.pi * k * f0 * t + 0.3 * k) for k in (1, 2, 3, 4, 5))
    sig = (sig + 0.01 * rng.normal(size=n)).astype(np.float32)
    nf = n // HOP
    track = np.full((1, nf), f0, np.float32)
    flip = np.r_[np.ones(nf // 2), np.zeros(nf - nf // 2)].astype(np.float32)[None]

    def port(vuv=None, a=tap.DEFAULT_ANALYSIS):
        return tap._psync_peaks_valleys(_t(sig[None]), _t(track), FS, HOP, nf, 20,
                                        vuv=None if vuv is None else _t(vuv), ap=a)

    p1, v1 = port(flip, ap)
    jp1, jv1 = jap._psync_peaks_valleys(jnp.asarray(sig), jnp.asarray(track[0]), FS, HOP, nf, 20,
                                        vuv=jnp.asarray(flip[0]),
                                        ap=dataclasses.replace(jap.DEFAULT_ANALYSIS, **vars(ap)))
    for got, want in ((p1, jp1), (v1, jv1)):
        want = np.asarray(want)
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-4 * np.abs(want).max())

    p0, v0 = port()
    pn, vn = port(np.ones((1, nf), np.float32), ap)
    assert torch.equal(pn, p0) and torch.equal(vn, v0)
    span = int(np.ceil(ap.ps_periods * FS / f0 / 2 / HOP)) + 2
    far = np.r_[np.arange(0, nf // 2 - span), np.arange(nf // 2 + span, nf)]
    assert torch.equal(p1[0, far], p0[0, far]) and torch.equal(v1[0, far], v0[0, far])
    near = np.arange(nf // 2 - 2, nf // 2 + 2)
    assert not torch.equal(p1[0, near], p0[0, near])
    assert torch.isfinite(p1).all() and torch.isfinite(v1).all()
    with pytest.raises(ValueError, match="ps_reflect/ps_shift"):
        port(None, ap)


def test_ps_shift_nm_only_shifts_the_noise_mask_alone(analysed):
    """With ``ps_shift_nm_only`` the harmonic envelope reads frame-centred
    windows (bit for bit the default reader's) while the noise mask
    shifts."""
    x, f0, vuv = analysed
    args = (_t(x), _t(f0), FS, HOP)
    nm_only = VARIANTS["ps_shift_nm_only"]
    e_base = tap.harmonic_envelope(*args, 1024, 60.0, vuv=_t(vuv))
    e_nm = tap.harmonic_envelope(*args, 1024, 60.0, vuv=_t(vuv), ap=nm_only)
    assert torch.equal(e_base, e_nm)
    m_base = tap.harmonic_noise_mask(*args, 17, 60.0, vuv=_t(vuv))
    m_nm = tap.harmonic_noise_mask(*args, 17, 60.0, vuv=_t(vuv), ap=nm_only)
    assert not torch.equal(m_base, m_nm)
    assert torch.equal(m_nm, tap.harmonic_noise_mask(*args, 17, 60.0, vuv=_t(vuv), ap=SHIFT))


@pytest.mark.parametrize("n,fl,hop", [(1000, 400, 80), (999, 320, 64), (400, 400, 80),
                                      (399, 400, 80), (0, 400, 80), (5000, 160, 200)])
def test_frame_signal_without_padding_matches_jax(n, fl, hop):
    """``pad=False``: the max(1 + (n − fl)//hop, 0) uncentred frames that
    lie inside the signal, exactly (slices, no arithmetic)."""
    x = np.random.default_rng(n + fl).normal(size=(2, n)).astype(np.float32)
    got = stft.frame_signal(_t(x), fl, hop, pad=False)
    nf = max(1 + (n - fl) // hop, 0)
    assert tuple(got.shape) == (2, nf, fl)
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jstft.frame_signal(jnp.asarray(x[b]), fl, hop,
                                                                    pad=False)))
