"""The port's demo corpus (``data/demo.py``) and compose stage
(``data/compose.py``) against the JAX package's.

* The demo corpus: every file (wavs, labels, ``questions.hed``,
  ``fileids.scp``, ``f0ref/``) byte for byte, with each option; ``cli demo``'s
  ``config.json`` equal to the JAX ``cli demo``'s.
* Compose from a shared feature cache, filled by either package: the
  stats, the normalized (and raw) datasets and the splits bit for bit, and
  ``cache_meta.json`` equal as JSON. The analysis itself is the port's
  ``PMLVocoder.analyze_batch`` (held against the JAX analysis by
  ``tests/test_torch_{dsp,vocoder}.py``): compose's features equal it
  exactly. A jitted JAX analysis can move a discontinuous estimator
  decision by an ulp, so features analyzed by the two packages are not
  compared here.
* The cache's invalidation, and the sample-rate, missing-file and
  label-length checks.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest

from percivaltts_tpu import cli as jax_cli
from percivaltts_tpu.config import Configuration as JaxConfiguration
from percivaltts_tpu.data import compose as jax_compose
from percivaltts_tpu.data.demo import generate_demo_corpus as jax_demo
from percivaltts_tpu_torch import cli
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data import compose
from percivaltts_tpu_torch.data.compose import load_wav, save_wav
from percivaltts_tpu_torch.data.demo import generate_demo_corpus
from percivaltts_tpu_torch.data.hts_labels import QuestionSet, binarize_label_file
from percivaltts_tpu_torch.vocoders import get_vocoder


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kw", [
    {},
    {"hard": True},
    {"encode_f0": True},
    {"jitter": 0.12, "speaker_f0": 140.0, "noise_snr_db": 20.0, "reverb_ms": 30.0},
], ids=["default", "hard", "encode_f0", "jitter_stressors"])
def test_demo_corpus_is_byte_identical(tmp_path, kw):
    ids = generate_demo_corpus(str(tmp_path / "port"), num_utterances=4, seed=11, **kw)
    assert ids == jax_demo(str(tmp_path / "jax"), num_utterances=4, seed=11, **kw)
    mine, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert len(mine) == 3 * 4 + 2 and mine.keys() == theirs.keys()
    for name in mine:
        assert mine[name] == theirs[name], name


def test_cli_demo_writes_the_jax_config(tmp_path):
    """``cli demo``'s ``config.json`` equals the JAX ``cli demo``'s byte for
    byte (the same corpus path), and loads into both packages."""
    out = str(tmp_path / "c")
    assert cli.main(["demo", "--out", out, "--num", "3", "--seed", "2"], device="cpu") == 0
    with open(os.path.join(out, "config.json"), "rb") as f:
        mine = f.read()
    ns = argparse.Namespace(out=out, num=3, seed=2, hard=False, jitter=0.0, speaker_f0=0.0,
                            encode_f0=False, noise_snr_db=0.0, reverb_ms=0.0)
    assert jax_cli.cmd_demo(ns) == 0
    with open(os.path.join(out, "config.json"), "rb") as f:
        assert f.read() == mine
    path = os.path.join(out, "config.json")
    assert dataclasses.asdict(Configuration.load(path)) == dataclasses.asdict(
        JaxConfiguration.load(path))


# --- compose ----------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    generate_demo_corpus(root, num_utterances=7, seed=5)
    return root


def _cfg_dict(root, workdir, **vocoder):
    d = Configuration(workdir=workdir).to_dict()
    d["data"].update(corpus_dir=root, fileids=os.path.join(root, "fileids.scp"),
                     question_file=os.path.join(root, "questions.hed"), num_valid=2, num_test=1)
    d["vocoder"].update({"spec_size": 33, "nm_size": 17, **vocoder})
    return d


def _assert_same_corpus(got, want):
    for name in ("in_stats", "out_stats"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.kind == w.kind
        np.testing.assert_array_equal(g.shift, w.shift)
        np.testing.assert_array_equal(g.scale, w.scale)
    for split in ("train", "valid", "test"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.ids == w.ids and len(g) == len(w)
        for a, b in zip(g.labs + g.cmps, w.labs + w.cmps):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("filler", ["jax", "port"])
@pytest.mark.parametrize("normalize", [True, False])
def test_compose_from_a_shared_cache_equals_the_jax_compose(corpus, tmp_path, filler, normalize):
    """One package analyzes into the cache, then each composes from it:
    equal stats, datasets and splits, and the same ``cache_meta.json``."""
    d = _cfg_dict(corpus, str(tmp_path / "exp"))
    jcfg, pcfg = JaxConfiguration.from_dict(d), Configuration.from_dict(d)
    cache = str(tmp_path / "cache")
    metas = {}
    if filler == "jax":
        jax_compose.compose(jcfg, cache_dir=cache, normalize=normalize)
        with open(os.path.join(cache, "cache_meta.json")) as f:
            metas["jax"] = json.load(f)
    got = compose.compose(pcfg, cache_dir=cache, normalize=normalize, device="cpu")
    with open(os.path.join(cache, "cache_meta.json")) as f:
        metas["port"] = json.load(f)
    want = jax_compose.compose(jcfg, cache_dir=cache, normalize=normalize)
    with open(os.path.join(cache, "cache_meta.json")) as f:
        metas["jax"] = json.load(f)
    assert metas["port"] == metas["jax"]
    assert len([f for f in os.listdir(cache) if f.endswith(".f32")]) == 14
    _assert_same_corpus(got, want)
    assert (len(got.train), len(got.valid), len(got.test)) == (4, 2, 1)
    if normalize:
        # the nm stream is kept as it is (shift 0, scale 1)
        a, b = get_vocoder(pcfg.vocoder, "cpu").streams["nm"]
        assert (got.out_stats.shift[a:b] == 0).all() and (got.out_stats.scale[a:b] == 1).all()


def test_compose_features_are_the_ports_analysis(corpus, tmp_path):
    """Raw features equal ``PMLVocoder.analyze_batch`` of the wavs (one
    chunk of 7), labels the binarized label files."""
    pcfg = Configuration.from_dict(_cfg_dict(corpus, str(tmp_path / "exp")))
    got = compose.compose(pcfg, normalize=False, device="cpu")
    ids = got.train.ids + got.valid.ids + got.test.ids
    wavs = [load_wav(os.path.join(corpus, "wav", uid + ".wav"))[1] for uid in ids]
    want = get_vocoder(pcfg.vocoder, "cpu").analyze_batch(wavs)
    q = QuestionSet.from_hed(pcfg.data.question_file)
    cmps = got.train.cmps + got.valid.cmps + got.test.cmps
    labs = got.train.labs + got.valid.labs + got.test.labs
    for uid, c, w, lab in zip(ids, cmps, want, labs):
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(
            lab, binarize_label_file(os.path.join(corpus, "label_state_align", uid + ".lab"),
                                     q, pcfg.vocoder.shift_ms / 1000.0))


def test_stale_cache_is_recomputed_and_decision_rules_are_not_stale(corpus, tmp_path, capsys):
    """A feature-defining change (nm_size) drops the cache and analyzes
    again; the prediction-side voicing rule, which analysis does not read,
    keeps it."""
    cache = str(tmp_path / "cache")

    def run(**vocoder):
        cfg = Configuration.from_dict(_cfg_dict(corpus, str(tmp_path / "exp"), **vocoder))
        out = compose.compose(cfg, cache_dir=cache, device="cpu")
        log = capsys.readouterr().out
        return out, log

    first, log = run()
    assert "(7 analyzed)" in log
    _, log = run(vuv_pred_low_frac=0.65, vuv_pred_threshold=0.6)
    assert "(0 analyzed)" in log and "stale" not in log
    again, log = run(nm_size=9)
    assert "feature cache is stale" in log and "(7 analyzed)" in log
    assert again.train.feat_dim == 1 + 33 + 9 and first.train.feat_dim == 1 + 33 + 17


@pytest.mark.parametrize("cache_state", ["empty", "filled", "stale"])
def test_a_reading_rank_composes_without_writing_the_cache(corpus, tmp_path, capsys,
                                                           cache_state):
    """``write_cache=False`` (a data-parallel rank other than 0) gives the
    writer's corpus and leaves the cache directory byte for byte as it
    found it: it reads a filled cache, and analyzes itself when the cache
    is empty or its ``cache_meta.json`` is another analysis's (whose
    features it must not read: one of them is garbage here)."""
    cfg = Configuration.from_dict(_cfg_dict(corpus, str(tmp_path / "exp")))
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    want = compose.compose(cfg, cache_dir=str(tmp_path / "writer"), device="cpu")
    if cache_state != "empty":
        compose.compose(cfg, cache_dir=cache, device="cpu")
    if cache_state == "stale":
        meta = os.path.join(cache, "cache_meta.json")
        with open(meta) as f:
            stale = json.load(f)
        stale["questions_dim"] += 1
        with open(meta, "w") as f:
            json.dump(stale, f)
        garbage = os.path.join(cache, want.train.ids[0] + ".cmp.f32")
        np.full(os.path.getsize(garbage) // 4, 7.0, np.float32).tofile(garbage)
    before = _tree(cache)
    capsys.readouterr()
    got = compose.compose(cfg, cache_dir=cache, device="cpu", write_cache=False)
    analyzed = 0 if cache_state == "filled" else 7
    assert f"({analyzed} analyzed)" in capsys.readouterr().out
    assert _tree(cache) == before
    _assert_same_corpus(got, want)


def test_compose_checks_sample_rate_files_and_label_length(corpus, tmp_path, capsys):
    root = str(tmp_path / "bad")
    generate_demo_corpus(root, num_utterances=4, seed=9)
    cfg = Configuration.from_dict(_cfg_dict(root, str(tmp_path / "exp")))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_valid=1, num_test=1))
    ids = open(cfg.data.fileids).read().split()
    wav_path = os.path.join(root, "wav", ids[1] + ".wav")
    fs, wav = load_wav(wav_path)

    # a label file 40% longer than its audio: composed (cropped later), with a warning
    lab_path = os.path.join(root, "label_state_align", ids[2] + ".lab")
    lines = open(lab_path).read().splitlines()
    end = int(lines[-1].split()[1])
    lines.append(f"{end} {int(end * 1.4)} {lines[-1].split()[2]}")
    open(lab_path, "w").write("\n".join(lines) + "\n")
    compose.compose(cfg, device="cpu")
    assert f"WARNING utterance {ids[2]!r}" in capsys.readouterr().out

    save_wav(wav_path, 8000, wav[::2])
    with pytest.raises(ValueError, match="sample rate 8000 != configured vocoder fs 16000"):
        compose.compose(cfg, device="cpu")
    os.remove(wav_path)
    with pytest.raises(FileNotFoundError, match="no waveform at"):
        compose.compose(cfg, device="cpu")
    save_wav(wav_path, fs, wav)
    os.remove(lab_path)
    with pytest.raises(FileNotFoundError, match="no HTS label at"):
        compose.compose(cfg, device="cpu")


def test_normalize_inplace_is_the_native_numpy_form():
    """``(x − shift)·scale`` rounded after each operation, in place."""
    from percivaltts_tpu import native

    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 7)).astype(np.float32) * 3
    shift = rng.normal(size=7).astype(np.float32)
    scale = rng.uniform(0.1, 3, size=7).astype(np.float32)
    want = native.normalize_inplace(x.copy(), shift, scale)
    y = x.copy()
    got = compose.normalize_inplace(y, shift, scale)
    assert got is y
    np.testing.assert_array_equal(got, want)
