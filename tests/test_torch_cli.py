"""The port's command line (``cli.py``) end to end on the CPU:
``main(argv, device="cpu")`` runs demo → compose → train → generate →
measures on a miniature corpus, asserting what the JAX package's pipeline
test (``tests/test_e2e.py``) asserts of it, then the production preset's
device-corpus run with objective-measure validation, resumed; ``export``
and ``plot`` on a trained workdir. The preset overlay equals the JAX
``apply_preset``'s; ``train --mesh`` / ``--distributed`` train over a
process group of one.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from percivaltts_tpu import cli as jax_cli
from percivaltts_tpu.config import Configuration as JaxConfiguration
from percivaltts_tpu_torch import cli
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.compose import compose
from percivaltts_tpu_torch.utils.fileio import save_binary_file
from percivaltts_tpu_torch.vocoders import get_vocoder


def _main(*argv):
    return cli.main(list(argv), device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo_corpus"))
    assert _main("demo", "--out", root, "--num", "12", "--seed", "7") == 0
    return root


def _write_cfg(corpus_root, workdir, **overrides):
    """The e2e test's config: config 1's FC generator at width 32, LSE."""
    with open(os.path.join(corpus_root, "config.json")) as f:
        d = json.load(f)
    d["workdir"] = workdir
    d["data"].update(batch_size=2, bucket_bounds=[256], num_valid=2, num_test=2)
    d["vocoder"].update(spec_size=33, nm_size=17)
    d["model"].update(generator="fc", hidden_size=32, num_layers=2, compute_dtype="float32")
    d["train"].update(trainer="lse", epochs=3, lr_gen=2e-3, checkpoint_every=1)
    for k, v in overrides.items():
        d[k].update(v)
    path = os.path.join(workdir, "cfg.json")
    os.makedirs(workdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _records(workdir, kind):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_demo_corpus_files(corpus):
    ids = open(os.path.join(corpus, "fileids.scp")).read().split()
    assert len(ids) == 12
    assert os.path.exists(os.path.join(corpus, "wav", ids[0] + ".wav"))
    assert os.path.exists(os.path.join(corpus, "label_state_align", ids[0] + ".lab"))
    assert os.path.exists(os.path.join(corpus, "questions.hed"))


def test_compose_train_generate_measures(corpus, tmp_path):
    workdir = str(tmp_path / "exp")
    cfg_path = _write_cfg(corpus, workdir)

    assert _main("compose", "--config", cfg_path) == 0
    assert os.path.exists(os.path.join(workdir, "in_stats.npz"))
    assert os.path.exists(os.path.join(workdir, "out_stats.npz"))
    cache = os.path.join(workdir, "feature_cache")
    assert len([f for f in os.listdir(cache) if f.endswith(".f32")]) == 24  # 12 × (lab + cmp)

    assert _main("train", "--config", cfg_path) == 0
    epochs = _records(workdir, "epoch")
    assert len(epochs) == 3
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["valid"]) for m in epochs)
    assert epochs[-1]["loss"] < epochs[0]["loss"]

    assert _main("generate", "--config", cfg_path, "--save-features") == 0
    with open(os.path.join(workdir, "measures.json")) as f:
        measures = json.load(f)
    assert np.isfinite(measures["mcd_db"]) and measures["mcd_db"] > 0
    assert "f0_rmse_hz" in measures and np.isfinite(measures["f0_rmse_hz"])
    assert "vuv_error_pct" in measures
    assert all(np.isfinite(measures[k]) for k in ("gv_ratio", "ms_ratio_hi"))
    gen_dir = os.path.join(workdir, "generated")
    assert len([f for f in os.listdir(gen_dir) if f.endswith(".wav")]) == 2  # num_test
    assert len([f for f in os.listdir(gen_dir) if f.endswith(".cmp")]) == 2

    # measures on the saved predictions against the denormalized references
    # gives generate's MCD
    cfg = Configuration.load(cfg_path)
    test = compose(cfg, cache_dir=cache, device="cpu")
    ref_dir = str(tmp_path / "ref")
    for uid, c in zip(test.test.ids, test.test.cmps):
        save_binary_file(os.path.join(ref_dir, uid + ".cmp"), test.out_stats.denormalize(c))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert _main("measures", "--config", cfg_path, "--ref", ref_dir, "--pred", gen_dir) == 0
    got = json.loads(out.getvalue())
    assert got["files"] == 2
    np.testing.assert_allclose(got["mcd_db"], measures["mcd_db"], rtol=1e-5)
    # the same voicing decisions, averaged in f32 here and in f64 there
    np.testing.assert_allclose(got["vuv_error_pct"], measures["vuv_error_pct"], rtol=1e-6)

    # generate from the latest checkpoint, on the validation split, no wavs
    assert _main("generate", "--config", cfg_path, "--latest", "--split", "valid", "--no-wav") == 0


@pytest.mark.parametrize("kind", ["melspec", "world"])
def test_compose_train_generate_the_other_vocoders(corpus, tmp_path, kind):
    """``compose`` with config 4's mel-spectrogram target and with WORLD:
    the port analyzes into the feature cache, and the JAX ``compose`` from
    that cache gives the same ``cache_meta.json``, stats, datasets and
    splits, bit for bit (WORLD's bounded vuv and bap streams left as they
    are); then 1 epoch of ``train`` with measure validation choosing the
    best checkpoint on ``mcd_gv`` (MCD on the mel cepstra alone for
    melspec), and ``generate --no-wav``."""
    from percivaltts_tpu.data import compose as jax_compose

    workdir = str(tmp_path / kind)
    cfg_path = _write_cfg(corpus, workdir, vocoder={"kind": kind}, train={
        "epochs": 1, "measures_every": 1, "best_metric": "mcd_gv"})
    assert _main("compose", "--config", cfg_path) == 0
    cache = os.path.join(workdir, "feature_cache")
    with open(os.path.join(cache, "cache_meta.json")) as f:
        meta = json.load(f)
    cfg = Configuration.load(cfg_path)
    got = compose(cfg, cache_dir=cache, device="cpu")
    want = jax_compose.compose(JaxConfiguration.load(cfg_path), cache_dir=cache)
    with open(os.path.join(cache, "cache_meta.json")) as f:
        assert json.load(f) == meta and meta["vocoder"]["kind"] == kind
    for name in ("in_stats", "out_stats"):
        np.testing.assert_array_equal(getattr(got, name).shift, getattr(want, name).shift)
        np.testing.assert_array_equal(getattr(got, name).scale, getattr(want, name).scale)
    for split in ("train", "valid", "test"):
        g, w = getattr(got, split), getattr(want, split)
        assert g.ids == w.ids
        for a, b in zip(g.labs + g.cmps, w.labs + w.cmps):
            np.testing.assert_array_equal(a, b)
    voc = get_vocoder(cfg.vocoder, "cpu")
    assert got.train.feat_dim == voc.feature_size == (80 if kind == "melspec" else 2 + 33 + 17)
    kept = [voc.streams[k] for k in ("vuv", "bap") if k in voc.streams]
    assert len(kept) == (2 if kind == "world" else 0)
    for a, b in kept:
        assert (got.out_stats.shift[a:b] == 0).all() and (got.out_stats.scale[a:b] == 1).all()

    assert _main("train", "--config", cfg_path) == 0
    (rec,), (obj,) = _records(workdir, "epoch"), _records(workdir, "objective")
    assert np.isfinite(rec["loss"]) and np.isfinite(obj["mcd_db"]) and np.isfinite(obj["gv_ratio"])
    assert ("vuv_error_pct" in obj) == (kind == "world")
    assert os.listdir(os.path.join(workdir, "checkpoints")) == ["0"]
    assert _main("generate", "--config", cfg_path, "--no-wav") == 0
    with open(os.path.join(workdir, "measures.json")) as f:
        measures = json.load(f)
    assert np.isfinite(measures["mcd_db"]) and ("vuv_error_pct" in measures) == (kind == "world")
    assert "f0_rmse_hz" not in measures if kind == "melspec" else True


def test_production_preset_trains_on_the_device_corpus_and_resumes(corpus, tmp_path):
    """``train --preset production`` with measures every epoch: the corpus
    on the device, EMA 0.995, one ``objective`` record an epoch and MCD as
    the best metric; ``--resume`` continues to the configured epochs."""
    workdir = str(tmp_path / "prod")
    cfg_path = _write_cfg(corpus, workdir, train={"epochs": 2, "measures_every": 1,
                                                  "best_metric": "mcd"})
    assert _main("train", "--config", cfg_path, "--preset", "production") == 0
    used = Configuration.load(os.path.join(workdir, "config.json"))
    assert used.train.device_corpus and used.train.ema_decay == 0.995
    epochs = _records(workdir, "epoch")
    # 8 training utterances: 4 steps of 2 an epoch, padded frames counted
    assert [r["steps"] for r in epochs] == [4, 4]
    assert [r["epoch"] for r in _records(workdir, "objective")] == [0, 1]

    with open(cfg_path) as f:
        d = json.load(f)
    d["train"]["epochs"] = 3
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    assert _main("train", "--config", cfg_path, "--preset", "production", "--resume") == 0
    assert [r["epoch"] for r in _records(workdir, "epoch")] == [0, 1, 2]
    assert _main("generate", "--config", cfg_path, "--no-wav") == 0


@pytest.mark.parametrize("train,vocoder", [
    ({"trainer": "lse"}, {}),
    ({"trainer": "wgan", "measures_every": 2}, {}),
    ({"trainer": "wgan"}, {"vuv_pred_threshold": 0.5}),
    ({"trainer": "lse"}, {"kind": "world"}),
])
def test_production_preset_equals_the_jax_overlay(train, vocoder):
    d = Configuration().to_dict()
    d["train"].update(train)
    d["vocoder"].update(vocoder)
    got = cli.apply_preset(Configuration.from_dict(d), "production")
    want = jax_cli.apply_preset(JaxConfiguration.from_dict(d), "production")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the overlaid vocoder builds (WORLD's with the bap voicing rule)
    voc = get_vocoder(got.vocoder, device="cpu")
    assert voc.kind == got.vocoder.kind and voc.cfg == got.vocoder
    assert voc.cfg.vuv_rule == ("bap" if voc.kind == "world" else "stream")
    with pytest.raises(ValueError, match="unknown preset"):
        cli.apply_preset(Configuration(), "fast")


def test_unported_options_and_commands(corpus, tmp_path, monkeypatch):
    """``train --mesh`` trains data-parallel over a gloo group of one that it
    makes and leaves; ``--distributed`` joins the group that
    ``torch.distributed.run``'s environment describes. Both write the run's
    records. ``export`` and ``plot`` on a workdir with no trained run say
    what is missing."""
    import socket

    import torch.distributed as dist

    joined = []
    init = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: joined.append((a, kw)) or init(*a, **kw))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for flag in ("--mesh", "--distributed"):
        workdir = str(tmp_path / flag.strip("-"))
        cfg_path = _write_cfg(corpus, workdir, train={"epochs": 1})
        if flag == "--distributed":  # the first run's features, composed once
            shutil.copytree(str(tmp_path / "mesh" / "feature_cache"),
                            os.path.join(workdir, "feature_cache"))
            for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                             RANK="0", LOCAL_RANK="0").items():
                monkeypatch.setenv(k, v)
        assert _main("train", "--config", cfg_path, flag) == 0
        assert not dist.is_initialized()
        assert len(_records(workdir, "epoch")) == 1
        assert os.listdir(os.path.join(workdir, "checkpoints")) == ["0"]
    assert [(a[0], kw["world_size"], kw["rank"]) for a, kw in joined] == [("gloo", 1, 0)] * 2
    assert joined[1][1]["init_method"] == f"tcp://localhost:{port}"
    cfg_path = _write_cfg(corpus, str(tmp_path / "x"))
    assert _main("compose", "--config", cfg_path) == 0
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _main("export", "--config", cfg_path)
    with pytest.raises(FileNotFoundError, match="metrics.jsonl"):
        _main("plot", "--config", cfg_path)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """The e2e config trained for 2 epochs, with the open-loop PML vocoder
    (one render: its synthesis graph exports in seconds; the closed loop's
    export is held in ``tests/test_torch_export.py``): its config path and
    workdir."""
    workdir = str(tmp_path_factory.mktemp("trained") / "exp")
    cfg_path = _write_cfg(corpus, workdir, train={"epochs": 2}, vocoder={"closed_loop": 0})
    assert _main("train", "--config", cfg_path) == 0
    return cfg_path, workdir


def _test_labels(cfg_path):
    """The test split's raw label matrices and ids, as ``generate`` reads them."""
    cfg = Configuration.load(cfg_path)
    c = compose(cfg, cache_dir=os.path.join(cfg.workdir, "feature_cache"), device="cpu")
    return [c.in_stats.denormalize(lab) for lab in c.test.labs], c


def test_export_writes_the_manifest_and_both_graphs(trained, tmp_path):
    """``export`` (best checkpoint, bound 256, batch 1): the manifest and one
    generator and one synthesis artifact; served on the CPU, the labels of
    the test split give the live generator's features (bucket-bound
    padding) and the vocoder's own waveforms."""
    from percivaltts_tpu_torch.eval.export import ExportedGenerator, ExportedSynthesizer
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import eval_generator, make_gan_state

    cfg_path, workdir = trained
    out = str(tmp_path / "export")
    assert _main("export", "--config", cfg_path, "--out", out) == 0
    assert sorted(os.listdir(out)) == ["gen_t256.pt2", "manifest.json", "syn_t256.pt2"]
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = Configuration.load(cfg_path)
    assert manifest["format"] == "torch.export" and manifest["torch_version"]
    assert (manifest["bounds"], manifest["batch"]) == ([256], 1)
    assert manifest["feat_dim"] == get_vocoder(cfg.vocoder, "cpu").feature_size
    assert manifest["synthesis"] == {"bounds": [256], "hop": 80, "batch": 1}
    assert Configuration.from_dict({"vocoder": manifest["vocoder"]}).vocoder == cfg.vocoder

    labs, c = _test_labels(cfg_path)
    feats = ExportedGenerator(out, device="cpu").predict_batch(labs)
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    state = ckpt.restore(make_gan_state(cfg, c.train.label_dim, device="cpu"), ckpt.best_step())
    gen = eval_generator(state)
    for lab, f in zip(labs, feats):
        x = np.zeros((1, 256, lab.shape[1]), np.float32)
        x[0, : len(lab)] = c.in_stats.normalize(lab)
        with torch.inference_mode():
            want = c.out_stats.denormalize(gen(torch.from_numpy(x)).numpy()[0, : len(lab)])
        np.testing.assert_allclose(f, want, atol=1e-5)
    syn = ExportedSynthesizer(out, device="cpu")
    voc = get_vocoder(cfg.vocoder, "cpu")
    for f in feats:
        assert np.array_equal(syn(f), voc.synthesize(f, seed=0))


def test_export_no_synth_writes_no_synthesis(trained, tmp_path):
    cfg_path, _ = trained
    out = str(tmp_path / "export")
    assert _main("export", "--config", cfg_path, "--out", out, "--no-synth") == 0
    assert sorted(os.listdir(out)) == ["gen_t256.pt2", "manifest.json"]
    with open(os.path.join(out, "manifest.json")) as f:
        assert "synthesis" not in json.load(f)


def test_export_batch_sets_the_manifest(trained, tmp_path):
    from percivaltts_tpu_torch.eval.export import ExportedGenerator

    cfg_path, _ = trained
    out = str(tmp_path / "export")
    assert _main("export", "--config", cfg_path, "--out", out, "--batch", "4", "--no-synth",
                 "--checkpoint", "1") == 0
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["batch"] == 4
    ex = ExportedGenerator(out, device="cpu")
    labs, _ = _test_labels(cfg_path)
    assert ex.batch == 4
    F = Configuration.load(cfg_path).vocoder.feature_size
    assert [f.shape for f in ex.predict_batch(labs)] == [(len(lab), F) for lab in labs]


def test_plot_writes_curves(trained):
    cfg_path, workdir = trained
    assert _main("plot", "--config", cfg_path) == 0
    png = os.path.join(workdir, "curves.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
