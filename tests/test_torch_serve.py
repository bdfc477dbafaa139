"""The serving slice as a whole: raw labels → features → wavs, port against
JAX.

JAX side: normalize → ``models.base.predict_batch`` → denormalize, as
``percivaltts_tpu/cli.py`` synth does, then its PML vocoder for ``cli
synth``. Tiny widths, f32, tolerance atol = rtol = 1e-4 on denormalized
features (scales up to 2); the wavs' tolerance is stated in
``_check_cli_synth``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.data.hts_labels import QuestionSet, binarize_label_file
from percivaltts_tpu.data.normalize import NormStats
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import predict_batch as jax_predict_batch
from percivaltts_tpu.data.compose import load_wav
from percivaltts_tpu.data.compose import save_wav as jax_save_wav
from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder
from percivaltts_tpu_torch import cli, weights
from percivaltts_tpu_torch.eval.serve import serve
from percivaltts_tpu_torch.models import build_generator, predict_batch, predict_utterance
from percivaltts_tpu_torch.vocoders.pml import PMLVocoder

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
LENGTHS = (5, 64, 70, 130, 131)  # pad groups 64, 64, 128, 192, 192
WEIGHTS = "generator.npz"  # a flax-path .npz, served with --weights


def _setup(label_dim, seed=0, **model_kw):
    cfg = _tiny_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32", **model_kw))
    rng = np.random.default_rng(seed)
    F = cfg.vocoder.feature_size

    def stats(dim):
        return NormStats(
            shift=rng.normal(size=dim).astype(np.float32),
            scale=rng.uniform(0.5, 2.0, size=dim).astype(np.float32),
        )

    in_stats, out_stats = stats(label_dim), stats(F)
    jg = jax_build_generator(cfg.model, cfg.vocoder, label_dim)
    params = jg.init(jax.random.key(seed), jnp.zeros((1, 64, label_dim), jnp.float32))
    tg = build_generator(cfg.model, cfg.vocoder, label_dim)
    weights.load_flax_params(tg, jax.tree.map(np.asarray, params))
    return cfg, in_stats, out_stats, jg, params, tg


def _jax_serve(jg, params, labs, in_stats, out_stats):
    labs_n = [in_stats.normalize(l).astype(np.float32) for l in labs]
    preds = jax_predict_batch(jg.apply, params, labs_n)
    return [out_stats.denormalize(p).astype(np.float32) for p in preds]


def test_serve_matches_jax_slice():
    cfg, in_stats, out_stats, jg, params, tg = _setup(label_dim=13)
    rng = np.random.default_rng(1)
    labs = [(rng.normal(size=(n, 13)) * 3 + 1).astype(np.float32) for n in LENGTHS]
    got = serve(tg, labs, in_stats, out_stats)
    want = _jax_serve(jg, params, labs, in_stats, out_stats)
    for n, g, w in zip(LENGTHS, got, want):
        assert g.dtype == np.float32 and g.shape == (n, cfg.vocoder.feature_size)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_predictions_do_not_depend_on_neighbours():
    """Each utterance sees its own 64-multiple padding whatever shares its
    chunk (the BiLSTM's backward direction reads the pad tail)."""
    _, _, _, _, _, tg = _setup(label_dim=13, seed=2)
    rng = np.random.default_rng(3)
    labs = [rng.normal(size=(n, 13)).astype(np.float32) for n in LENGTHS]
    batched = predict_batch(tg, labs, chunk=2)
    wide = predict_batch(tg, labs, chunk=8)
    for lab, b, w in zip(labs, batched, wide):
        alone = predict_utterance(tg, lab)
        np.testing.assert_allclose(b, alone, atol=1e-5)
        np.testing.assert_allclose(w, alone, atol=1e-5)


def test_serve_pads_in_normalized_space():
    """A request's tail is zero AFTER normalization: serving the raw label
    rows padded with raw zeros to the bound would change the result."""
    _, in_stats, out_stats, _, _, tg = _setup(label_dim=13, seed=4)
    lab = np.random.default_rng(5).normal(size=(70, 13)).astype(np.float32)
    served = serve(tg, [lab], in_stats, out_stats)[0]
    raw_padded = np.zeros((128, 13), np.float32)
    raw_padded[:70] = lab
    wrong = serve(tg, [raw_padded], in_stats, out_stats)[0][:70]
    assert np.abs(served - wrong).max() > 1e-3


def _workdir(tmp_path, cfg, in_stats, out_stats, params):
    cfg = cfg.replace(
        workdir=str(tmp_path),
        data=dataclasses.replace(
            cfg.data, question_file=os.path.join(FIXTURES, "questions_radio_style.hed")
        ),
    )
    cfg_path = cfg.dump()
    in_stats.save(str(tmp_path / "in_stats.npz"))
    out_stats.save(str(tmp_path / "out_stats.npz"))
    weights.save_npz(str(tmp_path / WEIGHTS), jax.tree.map(np.asarray, params))
    return cfg, cfg_path


def test_cli_synth_matches_jax_prediction(tmp_path, monkeypatch):
    _check_cli_synth(tmp_path, monkeypatch, seed=6)


def test_cli_synth_serves_a_bgru_generator(tmp_path, monkeypatch):
    """The weights ``.npz`` of a BGRU generator (2 layers of 8 units per
    direction, with its ``bhn`` leaves) through ``cli synth``."""
    _check_cli_synth(tmp_path, monkeypatch, seed=9, generator="bgru")


def _check_cli_synth(tmp_path, monkeypatch, seed, **model_kw):
    """``cli synth`` on the fixture corpus writes one wav per label file,
    equal to JAX serving → the JAX package's ``PMLVocoder.synthesize_batch``
    from the same weights, with the JAX noise draw handed to the port. The
    open loop (``closed_loop=0``): features from random weights can sit on a
    voicing threshold, which the closed loop's re-analyses would amplify (it
    is held in ``tests/test_torch_vocoder.py`` on well-conditioned
    features). Tolerance, after both waveforms are clipped and quantized as
    the wav file stores them: 2 16-bit steps plus 5e-3 of the largest
    sample. Features from random weights change voicing every few frames,
    and where the per-sample voicing gate crosses its threshold can move by
    a sample between the packages (a ramp step of 1/80 of the harmonic
    amplitude; seen: 1.8e-4 at a largest sample of 0.06)."""
    qs = QuestionSet.from_hed(os.path.join(FIXTURES, "questions_radio_style.hed"))
    label_dim = qs.dim + 9
    cfg, in_stats, _, jg, params, _ = _setup(label_dim, seed=seed, **model_kw)
    cfg = cfg.replace(vocoder=dataclasses.replace(cfg.vocoder, closed_loop=0))
    # output stats that put the features where speech's are (f0 near 120 Hz,
    # log amplitudes near -7, noise mask near 0.3), so the wavs stay within
    # [-1, 1] and are compared unclipped
    v = cfg.vocoder
    shift = np.concatenate([[np.log(120.0)], np.full(v.spec_size, -7.0), np.full(v.nm_size, 0.3)])
    out_stats = NormStats(shift=shift.astype(np.float32), scale=np.full(v.feature_size, 10.0, np.float32))
    cfg, cfg_path = _workdir(tmp_path, cfg, in_stats, out_stats, params)
    monkeypatch.setattr(
        PMLVocoder, "_noise",
        lambda self, n, s, device: torch.from_numpy(np.array(jax.random.normal(jax.random.key(s), (n,)))),
    )
    out = tmp_path / "wavs"
    rc = cli.main(
        ["synth", "--config", cfg_path, "--weights", str(tmp_path / WEIGHTS), "--out", str(out),
         os.path.join(FIXTURES, "utt00*.lab")],
        device="cpu",
    )
    assert rc == 0

    paths = sorted(glob.glob(os.path.join(FIXTURES, "utt00*.lab")))
    labs = [binarize_label_file(p, qs, cfg.vocoder.shift_ms / 1000.0) for p in paths]
    feats = _jax_serve(jg, params, labs, in_stats, out_stats)
    want = jax_get_vocoder(cfg.vocoder).synthesize_batch(feats)
    for p, lab, w in zip(paths, labs, want):
        uid = os.path.splitext(os.path.basename(p))[0]
        fs, got = load_wav(str(out / f"{uid}.wav"))
        assert fs == cfg.vocoder.fs and got.shape == (lab.shape[0] * cfg.vocoder.shift_samples,)
        jax_save_wav(str(tmp_path / "jax" / f"{uid}.wav"), fs, w)
        _, w16 = load_wav(str(tmp_path / "jax" / f"{uid}.wav"))
        np.testing.assert_allclose(got, w16, atol=2.0 / 32768 + 5e-3 * np.abs(w).max())
        assert 0.01 < np.abs(w).max() < 1.0  # sound, and no sample clipped


def test_cli_synth_refuses_missing_labels_and_weights(tmp_path):
    """No label file matches; ``--weights`` names a missing file; neither a
    checkpoint nor ``--weights`` (the error names the checkpoint
    directory)."""
    qs = QuestionSet.from_hed(os.path.join(FIXTURES, "questions_radio_style.hed"))
    cfg, in_stats, out_stats, _, params, _ = _setup(qs.dim + 9, seed=7)
    _, cfg_path = _workdir(tmp_path, cfg, in_stats, out_stats, params)
    wpath = str(tmp_path / WEIGHTS)
    with pytest.raises(FileNotFoundError, match="no label files"):
        cli.main(["synth", "--config", cfg_path, "--weights", wpath, str(tmp_path / "none*.lab")],
                 device="cpu")
    os.unlink(wpath)
    lab = os.path.join(FIXTURES, "utt001.lab")
    with pytest.raises(FileNotFoundError):
        cli.main(["synth", "--config", cfg_path, "--weights", wpath, lab], device="cpu")
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "checkpoints")):
        cli.main(["synth", "--config", cfg_path, lab], device="cpu")
    with open(cfg_path) as f:
        assert json.load(f)["workdir"] == str(tmp_path)


def _as_flax(gen, named):
    """Generator parameters by name in the port's layout → the flat
    flax-path tree ``weights.load_flax_params`` reads (the inverse of its
    mapping): per-gate leaves split off the last axis, Dense kernels
    transposed, Conv kernels back to (k, in, out)."""
    names = {id(p): n for n, p in gen.named_parameters()}
    flat = {}
    for keys, param, _ in weights._entries(gen):
        v = named[names[id(param)]].detach().cpu().numpy()
        if len(keys) > 1:
            flat.update(zip(keys, np.split(v, len(keys), axis=-1)))
        elif v.ndim == 2:
            flat[keys[0]] = v.T
        elif v.ndim == 3:
            flat[keys[0]] = v.transpose(2, 1, 0)
        else:
            flat[keys[0]] = v
    return flat


def test_cli_synth_serves_the_best_checkpoints_ema_weights(tmp_path, capsys):
    """One epoch of the port's ``Trainer`` (LSE, EMA decay 0.5) on the CPU,
    then ``cli synth`` with no ``--weights``: its wavs equal those served
    from an ``.npz`` holding the best checkpoint's EMA, and are far from
    those of the live weights. Equal within 2 16-bit steps plus 5e-3 of the
    largest sample, as in ``_check_cli_synth``, not bit for bit: on the CPU
    a GEMM's rounding depends on where its operands lie in memory (a deep
    copy of one generator can serve features that differ in their last
    bits), and the served features take the vocoder's voicing decisions."""
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.dataset import Dataset
    from percivaltts_tpu_torch.training import Trainer

    qs = QuestionSet.from_hed(os.path.join(FIXTURES, "questions_radio_style.hed"))
    label_dim = qs.dim + 9
    cfg, in_stats, _, _, params, _ = _setup(label_dim, seed=12)
    v = cfg.vocoder
    shift = np.concatenate([[np.log(120.0)], np.full(v.spec_size, -7.0), np.full(v.nm_size, 0.3)])
    out_stats = NormStats(shift=shift.astype(np.float32), scale=np.full(v.feature_size, 10.0, np.float32))
    cfg, cfg_path = _workdir(tmp_path, cfg, in_stats, out_stats, params)
    cfg = Configuration.load(cfg_path)
    cfg = cfg.replace(
        vocoder=dataclasses.replace(cfg.vocoder, closed_loop=0),
        train=dataclasses.replace(cfg.train, trainer="lse", ema_decay=0.5, lr_gen=1e-2),
    )
    rng = np.random.default_rng(13)
    data = [(rng.normal(size=(n, label_dim)).astype(np.float32),
             rng.normal(size=(n, v.feature_size)).astype(np.float32)) for n in range(40, 64, 2)]
    ds = Dataset([a for a, _ in data], [b for _, b in data])
    trainer = Trainer(cfg, ds, ds, device="cpu")
    trainer.train(epochs=1)
    trainer.close()
    assert trainer.ckpt.best_step() == 0
    cfg_path = cfg.dump()

    ema_npz, live_npz = str(tmp_path / "ema.npz"), str(tmp_path / "live.npz")
    weights.save_npz(ema_npz, _as_flax(trainer.state.gen, trainer.state.ema))
    weights.save_npz(live_npz, _as_flax(trainer.state.gen, dict(trainer.state.gen.named_parameters())))
    check = build_generator(cfg.model, cfg.vocoder, label_dim)
    weights.load_flax_params(check, weights.load_npz(ema_npz))
    for n, p in check.named_parameters():
        assert torch.equal(p, trainer.state.ema[n]), n

    labs = os.path.join(FIXTURES, "utt00*.lab")
    wavs = {}
    for name, extra in (("best", []), ("ema", ["--weights", ema_npz]), ("live", ["--weights", live_npz])):
        out = tmp_path / name
        assert cli.main(["synth", "--config", cfg_path, *extra, "--out", str(out), labs],
                        device="cpu") == 0
        wavs[name] = [load_wav(str(out / f))[1] for f in sorted(os.listdir(out))]
    assert "from checkpoint step 0 (EMA generator weights)" in capsys.readouterr().out
    assert len(wavs["best"]) == len(glob.glob(labs)) > 0
    for best, ema, live in zip(wavs["best"], wavs["ema"], wavs["live"]):
        tol = 2.0 / 32768 + 5e-3 * np.abs(ema).max()
        np.testing.assert_allclose(best, ema, atol=tol)
        assert np.abs(best - live).max() > 20 * tol
