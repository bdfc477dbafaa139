"""The serving slice as a whole: raw labels → features, port against JAX.

JAX side: normalize → ``models.base.predict_batch`` → denormalize, as
``percivaltts_tpu/cli.py`` synth does. Tiny widths, f32, tolerance
atol = rtol = 1e-4 on denormalized features (scales up to 2).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.data.hts_labels import QuestionSet, binarize_label_file
from percivaltts_tpu.data.normalize import NormStats
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import predict_batch as jax_predict_batch
from percivaltts_tpu.utils.fileio import load_binary_file
from percivaltts_tpu_torch import cli, weights
from percivaltts_tpu_torch.eval.serve import serve
from percivaltts_tpu_torch.models import build_generator, predict_batch, predict_utterance

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
LENGTHS = (5, 64, 70, 130, 131)  # pad groups 64, 64, 128, 192, 192


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
    weights.save_npz(str(tmp_path / cli.WEIGHTS_FILE), jax.tree.map(np.asarray, params))
    return cfg, cfg_path


def test_cli_synth_matches_jax_prediction(tmp_path, capsys):
    _check_cli_synth(tmp_path, seed=6)
    assert "vocoder port" in capsys.readouterr().out


def test_cli_synth_serves_a_bgru_generator(tmp_path):
    """The weights ``.npz`` of a BGRU generator (2 layers of 8 units per
    direction, with its ``bhn`` leaves) through ``cli synth``."""
    _check_cli_synth(tmp_path, seed=9, generator="bgru")


def _check_cli_synth(tmp_path, seed, **model_kw):
    """``cli synth`` on the fixture corpus against the JAX prediction from
    the same weights."""
    qs = QuestionSet.from_hed(os.path.join(FIXTURES, "questions_radio_style.hed"))
    label_dim = qs.dim + 9
    cfg, in_stats, out_stats, jg, params, _ = _setup(label_dim, seed=seed, **model_kw)
    cfg, cfg_path = _workdir(tmp_path, cfg, in_stats, out_stats, params)
    out = tmp_path / "feats"
    rc = cli.main(
        ["synth", "--config", cfg_path, "--out", str(out), os.path.join(FIXTURES, "utt00*.lab")],
        device="cpu",
    )
    assert rc == 0

    paths = sorted(glob.glob(os.path.join(FIXTURES, "utt00*.lab")))
    labs = [binarize_label_file(p, qs, cfg.vocoder.shift_ms / 1000.0) for p in paths]
    want = _jax_serve(jg, params, labs, in_stats, out_stats)
    F = cfg.vocoder.feature_size
    for p, w in zip(paths, want):
        uid = os.path.splitext(os.path.basename(p))[0]
        got = load_binary_file(str(out / f"{uid}.cmp"), F)
        assert got.shape == w.shape == (labs[paths.index(p)].shape[0], F)
        np.testing.assert_allclose(got, w, atol=1e-4, rtol=1e-4)


def test_cli_synth_refuses_missing_labels_and_weights(tmp_path):
    qs = QuestionSet.from_hed(os.path.join(FIXTURES, "questions_radio_style.hed"))
    cfg, in_stats, out_stats, _, params, _ = _setup(qs.dim + 9, seed=7)
    _, cfg_path = _workdir(tmp_path, cfg, in_stats, out_stats, params)
    with pytest.raises(FileNotFoundError, match="no label files"):
        cli.main(["synth", "--config", cfg_path, str(tmp_path / "none*.lab")], device="cpu")
    os.unlink(tmp_path / cli.WEIGHTS_FILE)
    with pytest.raises(FileNotFoundError):
        cli.main(["synth", "--config", cfg_path, os.path.join(FIXTURES, "utt001.lab")], device="cpu")
    with open(cfg_path) as f:
        assert json.load(f)["workdir"] == str(tmp_path)
