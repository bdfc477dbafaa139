"""The port's objective measures (``eval/measures.py``), ``Vocoder.cepstra``
and the generation stage (``eval/generate.py``) against the JAX package's.

Measures: each function on the same numpy inputs, with and without masks,
rtol 1e-5 (f32 sums and the DCT product in another order). Generation:
``generate(synthesize=False)`` of the port and of the JAX package on the
same carried state (an FC generator, f32, with an EMA copy that differs
from the live weights) and the same normalized split, rtol 1e-4 on every
measure (the predictions agree to f32 rounding, and MCD, GV and the
modulation spectrum are sums over thousands of frames); the voicing
error is a count of decisions, compared exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.data.dataset import Dataset as JaxDataset
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.eval import measures as jm
from percivaltts_tpu.eval.generate import generate as jax_generate
from percivaltts_tpu.training.state import make_gan_state as jax_make_gan_state
from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset
from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.eval import measures as pm
from percivaltts_tpu_torch.eval.generate import generate
from percivaltts_tpu_torch.training.state import make_gan_state
from percivaltts_tpu_torch.utils.fileio import load_binary_file
from percivaltts_tpu_torch.vocoders import get_vocoder

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    B, T, D = 3, 150, 25
    mask = (np.arange(T) < rng.integers(60, T + 1, size=B)[:, None]).astype(np.float32)
    return {
        "spec": rng.normal(size=(B, T, 33)).astype(np.float32) - 4.0,
        "c1": rng.normal(size=(B, T, D)).astype(np.float32),
        "c2": (rng.normal(size=(B, T, D)) * 0.7).astype(np.float32),
        "f1": rng.uniform(80, 300, size=(B, T)).astype(np.float32),
        "f2": rng.uniform(80, 300, size=(B, T)).astype(np.float32),
        "v1": (rng.random((B, T)) < 0.6).astype(np.float32),
        "v2": (rng.random((B, T)) < 0.6).astype(np.float32),
        "mask": mask,
    }


@pytest.mark.parametrize("order", [None, 25, 40])
def test_log_spec_to_cepstra(data, order):
    """Orthonormal DCT-II, clamped to F (40 > 33)."""
    got = pm.log_spec_to_cepstra(data["spec"], order)
    _close(got, jm.log_spec_to_cepstra(jnp.asarray(data["spec"]), order), atol=1e-5)
    assert got.shape[-1] == min(order or 33, 33)


def test_vocoder_cepstra_equal_the_jax_vocoders():
    """``Vocoder.cepstra``: the spec stream of (2, 70, 51) features → c0..c24."""
    from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
    from percivaltts_tpu_torch.config import VocoderConfig

    feats = np.random.default_rng(1).normal(size=(2, 70, 51)).astype(np.float32)
    got = get_vocoder(VocoderConfig(spec_size=33, nm_size=17), "cpu").cepstra(feats)
    want = jax_get_vocoder(JaxVocoderConfig(spec_size=33, nm_size=17)).cepstra(feats)
    assert got.shape == want.shape == (2, 70, 25) and got.dtype == np.float32
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_mcd_and_per_frame_mcd(data, masked):
    m = data["mask"] if masked else None
    _close(pm.mcd(data["c1"], data["c2"], m), jm.mcd(data["c1"], data["c2"], m))
    _close(pm.mcd(data["c1"], data["c2"], m, exclude_c0=False),
           jm.mcd(data["c1"], data["c2"], m, exclude_c0=False))
    np.testing.assert_array_equal(pm.per_frame_mcd_np(data["c1"], data["c2"]),
                                  jm.per_frame_mcd_np(data["c1"], data["c2"]))


@pytest.mark.parametrize("masked", [False, True])
def test_f0_and_voicing_measures(data, masked):
    m = data["mask"] if masked else None
    args = (data["f1"], data["f2"], data["v1"], data["v2"])
    _close(pm.f0_rmse(*args, mask=m), jm.f0_rmse(*args, mask=m))
    _close(pm.f0_rmse_cents(*args, mask=m), jm.f0_rmse_cents(*args, mask=m))
    _close(pm.vuv_error(data["v1"], data["v2"], m), jm.vuv_error(data["v1"], data["v2"], m))


@pytest.mark.parametrize("masked", [False, True])
def test_global_variance_and_its_ratio(data, masked):
    m = data["mask"] if masked else None
    _close(pm.global_variance(data["c1"], m), jm.global_variance(data["c1"], m))
    _close(pm.global_variance(data["c1"][0]), jm.global_variance(data["c1"][0]))
    _close(pm.global_variance_ratio(data["c1"], data["c2"], m, m),
           jm.global_variance_ratio(data["c1"], data["c2"], m, m))
    _close(pm.global_variance_ratio(data["c1"], data["c2"], exclude_c0=False),
           jm.global_variance_ratio(data["c1"], data["c2"], exclude_c0=False))


@pytest.mark.parametrize("masked", [False, True])
def test_modulation_spectrum_and_its_ratio(data, masked):
    """Batched and single trajectories, longer and shorter (100 < 128)
    than a segment."""
    m = data["mask"] if masked else None
    _close(pm.modulation_spectrum(data["c1"], m), jm.modulation_spectrum(data["c1"], m),
           atol=1e-6)
    short = data["c1"][0, :100]
    _close(pm.modulation_spectrum(short, None if m is None else m[0, :100]),
           jm.modulation_spectrum(short, None if m is None else m[0, :100]), atol=1e-6)
    got = pm.modulation_spectrum_ratio(data["c1"], data["c2"], m, m)
    assert got.shape == (4,)
    _close(got, jm.modulation_spectrum_ratio(data["c1"], data["c2"], m, m))
    _close(pm.modulation_spectrum_ratio(data["c1"], data["c2"], m, m, frame_rate=100.0, seg=64),
           jm.modulation_spectrum_ratio(data["c1"], data["c2"], m, m, frame_rate=100.0, seg=64))


# --- the generation stage ---------------------------------------------------


def _split(rng, L, F, spec, lengths):
    """Normalized labels and features; the nm stream holds raw values in
    [0, 1], as compose leaves it."""
    labs, cmps = [], []
    for n in lengths:
        labs.append(rng.normal(size=(n, L)).astype(np.float32))
        c = rng.normal(size=(n, F)).astype(np.float32)
        c[:, 1 + spec:] = rng.random((n, F - 1 - spec))
        cmps.append(c)
    return labs, cmps


def test_generate_matches_the_jax_generation(tmp_path):
    """An FC generator (2 × 32, f32) with an EMA copy, 6 utterances in 3
    padded lengths and out_stats with the nm stream kept: the measures
    dict, and the saved denormalized predictions."""
    cfg = _tiny_cfg("lse")
    cfg = cfg.replace(
        workdir=str(tmp_path),
        vocoder=dataclasses.replace(cfg.vocoder, spec_size=33, nm_size=17),
        model=dataclasses.replace(cfg.model, generator="fc", num_layers=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, ema_decay=0.9),
    )
    pcfg = Configuration.from_dict(cfg.to_dict())
    L, F, spec = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.vocoder.spec_size
    rng = np.random.default_rng(4)
    labs, cmps = _split(rng, L, F, spec, (40, 63, 70, 128, 130, 200))
    ids = [f"u{i}" for i in range(len(labs))]
    shift = np.concatenate([[np.log(150.0)], np.full(spec, -5.0), np.zeros(F - 1 - spec)])
    scale = np.concatenate([[4.0], np.full(spec, 0.8), np.ones(F - 1 - spec)])
    stats = dict(shift=shift.astype(np.float32), scale=scale.astype(np.float32))

    js = jax.jit(lambda: jax_make_gan_state(cfg, L, seed=3))()
    # an EMA apart from the live weights, so generation must read the EMA
    js = js.replace(ema=jax.tree.map(lambda p: p * 0.9, js.gen.params))
    state = make_gan_state(pcfg, L, device="cpu")
    weights.load_flax_params(state.gen, jax.tree.map(np.asarray, js.gen.params))
    ema = weights._converted(state.gen, jax.tree.map(np.asarray, js.ema))
    names = {id(p): n for n, p in state.gen.named_parameters()}
    state.ema = {names[id(p)]: torch.from_numpy(v) for p, v in ema}

    want = jax_generate(cfg, js, JaxDataset(labs, cmps, ids), JaxNormStats(**stats),
                        outdir=str(tmp_path / "jax"), synthesize=False, save_features=True)
    got = generate(pcfg, state, Dataset(labs, cmps, ids), NormStats(**stats),
                   outdir=str(tmp_path / "port"), synthesize=False, save_features=True)
    print(f"generate, port vs JAX: {got} vs {want}")
    assert got.keys() == want.keys() and "f0_rmse_hz" in got
    for k in ("mcd_db", "gv_ratio", "ms_ratio_hi", "f0_rmse_hz"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["vuv_error_pct"] == want["vuv_error_pct"]
    np.testing.assert_allclose(got["ms_ratio_bands"], want["ms_ratio_bands"], atol=1.01e-4)
    for uid in ids:
        np.testing.assert_allclose(load_binary_file(str(tmp_path / "port" / f"{uid}.cmp"), F),
                                   load_binary_file(str(tmp_path / "jax" / f"{uid}.cmp"), F),
                                   rtol=1e-4, atol=1e-4)
    assert not os.path.exists(tmp_path / "port" / "u0.wav")
