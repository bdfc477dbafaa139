"""The port imports nothing of jax, flax or the JAX package, its copies of
the reference's framework-free modules agree with the originals, and its
chip smoke test refuses to run without a card.

The import checks run in fresh subprocesses: this suite's conftest imports
jax into the test process itself.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from percivaltts_tpu import config as jax_config
from percivaltts_tpu.data import dataset as jax_dataset
from percivaltts_tpu.data import hts_labels as jax_hts
from percivaltts_tpu.data import normalize as jax_normalize
from percivaltts_tpu.ops import warp as jax_warp
from percivaltts_tpu.utils import fileio as jax_fileio
from percivaltts_tpu.utils import curves as jax_curves
from percivaltts_tpu.utils import logging as jax_logging
from percivaltts_tpu.utils import prefetch as jax_prefetch
from percivaltts_tpu_torch import config
from percivaltts_tpu_torch.data import dataset, hts_labels, normalize
from percivaltts_tpu_torch.ops import warp
from percivaltts_tpu_torch.utils import curves, fileio, logging, prefetch

# import roots the port must never load: the frameworks and the JAX package
FORBIDDEN_ROOTS = ("jax", "flax", "jaxlib", "percivaltts_tpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LIST_AND_IMPORT = r"""
import importlib, json, pkgutil, sys
import percivaltts_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(json.dumps({"modules": mods,
                  "leaked": sorted(k for k in sys.modules if k.split(".")[0] in %r)}))
""" % (FORBIDDEN_ROOTS,)


def _run(code_or_args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_port_modules_import_without_jax_flax_or_the_jax_package():
    proc = _run(_LIST_AND_IMPORT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {
        "percivaltts_tpu_torch._build",
        "percivaltts_tpu_torch.cli",
        "percivaltts_tpu_torch.config",
        "percivaltts_tpu_torch.data.compose",
        "percivaltts_tpu_torch.data.dataset",
        "percivaltts_tpu_torch.data.demo",
        "percivaltts_tpu_torch.data.device_corpus",
        "percivaltts_tpu_torch.data.fetch",
        "percivaltts_tpu_torch.data.hts_labels",
        "percivaltts_tpu_torch.data.normalize",
        "percivaltts_tpu_torch.eval.export",
        "percivaltts_tpu_torch.eval.generate",
        "percivaltts_tpu_torch.eval.measures",
        "percivaltts_tpu_torch.eval.serve",
        "percivaltts_tpu_torch.models.critic",
        "percivaltts_tpu_torch.models.generators",
        "percivaltts_tpu_torch.models.rnn",
        "percivaltts_tpu_torch.ops.aperiodicity",
        "percivaltts_tpu_torch.ops.cheaptrick",
        "percivaltts_tpu_torch.ops.envelope",
        "percivaltts_tpu_torch.ops.f0",
        "percivaltts_tpu_torch.ops.frames_cuda",
        "percivaltts_tpu_torch.ops.gru_cuda",
        "percivaltts_tpu_torch.ops.lstm_cuda",
        "percivaltts_tpu_torch.ops.morph",
        "percivaltts_tpu_torch.ops.stft",
        "percivaltts_tpu_torch.ops.warp",
        "percivaltts_tpu_torch.parallel",
        "percivaltts_tpu_torch.parallel.distributed",
        "percivaltts_tpu_torch.parallel.mesh",
        "percivaltts_tpu_torch.training",
        "percivaltts_tpu_torch.training.checkpoints",
        "percivaltts_tpu_torch.training.loop",
        "percivaltts_tpu_torch.training.losses",
        "percivaltts_tpu_torch.training.lse",
        "percivaltts_tpu_torch.training.ondevice",
        "percivaltts_tpu_torch.training.state",
        "percivaltts_tpu_torch.training.wgan",
        "percivaltts_tpu_torch.utils.curves",
        "percivaltts_tpu_torch.utils.fileio",
        "percivaltts_tpu_torch.utils.logging",
        "percivaltts_tpu_torch.utils.prefetch",
        "percivaltts_tpu_torch.utils.profiling",
        "percivaltts_tpu_torch.vocoders.base",
        "percivaltts_tpu_torch.vocoders.pml",
        "percivaltts_tpu_torch.weights",
    } <= set(out["modules"])
    assert out["leaked"] == []


def test_port_sources_name_no_forbidden_import():
    root = os.path.join(REPO, "percivaltts_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    assert words[1].split(".")[0] not in FORBIDDEN_ROOTS, (p, line)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    """No CUDA here: the script exits non-zero and prints no result line.
    Alone in a directory (no package beside it) it fails the same way."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
            text=True, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
    else:
        proc = _run([script])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# --- the port's copies against the originals -------------------------------


def test_config_json_loads_to_equal_trees_in_both_packages(tmp_path):
    """A non-default ``config.json`` written by either package loads into
    the other to an equal ``dataclasses.asdict`` tree."""
    kw = dict(
        workdir=str(tmp_path / "exp"),
        data=dict(batch_size=16, bucket_bounds=(128, 256), label_dim=13),
        vocoder=dict(kind="world", spec_size=17, nm_size=5),
        model=dict(generator="bgru", blstm_size=64, dropout_rate=0.1),
        train=dict(n_critic=3, stream_weights=(("f0", 2.0),), gp_every=2),
    )
    trees = []
    for pkg in (jax_config, config):
        cfg = pkg.Configuration(
            workdir=kw["workdir"],
            data=pkg.DataConfig(**kw["data"]),
            vocoder=pkg.VocoderConfig(analysis=pkg.AnalysisParams(gate_theta=0.5), **kw["vocoder"]),
            model=pkg.ModelConfig(**kw["model"]),
            train=pkg.TrainConfig(**kw["train"]),
        )
        trees.append(dataclasses.asdict(cfg))
        path = cfg.dump(str(tmp_path / f"{pkg.__name__}.json"))
        for other in (jax_config, config):
            assert dataclasses.asdict(other.Configuration.load(path)) == trees[-1]
    assert trees[0] == trees[1]
    assert dataclasses.asdict(jax_config.Configuration()) == dataclasses.asdict(config.Configuration())


def test_norm_stats_npz_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    a = [rng.normal(size=(n, 7)).astype(np.float32) * 3 + 1 for n in (40, 25)]
    mine = normalize.compute_meanstd(a, keep_streams=[(5, 7)])
    theirs = jax_normalize.compute_meanstd(a, keep_streams=[(5, 7)])
    np.testing.assert_array_equal(mine.shift, theirs.shift)
    np.testing.assert_array_equal(mine.scale, theirs.scale)
    for src, dst in ((normalize, jax_normalize), (jax_normalize, normalize)):
        stats = src.compute_minmax(a)
        path = str(tmp_path / f"{src.__name__}.npz")
        stats.save(path)
        back = dst.NormStats.load(path)
        np.testing.assert_array_equal(back.shift, stats.shift)
        np.testing.assert_array_equal(back.scale, stats.scale)
        assert back.kind == stats.kind
        np.testing.assert_array_equal(back.normalize(a[0]), stats.normalize(a[0]))


def test_label_binarization_agrees_with_the_jax_package(tmp_path):
    """A question file and a state-aligned label file made here: the same
    (frames, questions + 9) array from both packages."""
    hed = tmp_path / "q.hed"
    hed.write_text('QS "C-a" {*-a+*}\nQS "C-b" {*-b+*}\nQS "L-sil" {sil^*}\n'
                   'CQS "Pos_Fw" {@(\\d+)_}\n')
    lines, t = [], 0
    for i, (ph, n) in enumerate((("a", 3), ("b", 5), ("a", 4))):
        for state in range(2, 7):
            lines.append(f"{t} {t + n * 50000} sil^x-{ph}+x=x@{i + 1}_3[{state}]")
            t += n * 50000
    lab = tmp_path / "u.lab"
    lab.write_text("\n".join(lines) + "\n")
    got = hts_labels.binarize_label_file(str(lab), hts_labels.QuestionSet.from_hed(str(hed)))
    want = jax_hts.binarize_label_file(str(lab), jax_hts.QuestionSet.from_hed(str(hed)))
    assert got.shape == want.shape == (t // 50000, 4 + 9)
    np.testing.assert_array_equal(got, want)


def test_feature_files_read_back_equal_across_packages(tmp_path):
    arr = np.random.default_rng(1).normal(size=(37, 11)).astype(np.float32)
    for src, dst in ((fileio, jax_fileio), (jax_fileio, fileio)):
        path = str(tmp_path / f"{src.__name__}.bin")
        src.save_binary_file(path, arr)
        assert open(path, "rb").read() == arr.astype("<f4").tobytes()
        np.testing.assert_array_equal(dst.load_binary_file(path, 11), arr)
    with pytest.raises(ValueError):
        fileio.load_binary_file(path, 10)


def test_metrics_log_lines_read_back_with_the_jax_reader(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    log = logging.MetricsLogger(path)
    log.log("train_step", step=1, loss=np.float32(0.5))
    log.log("valid", loss=0.25)
    log.close()
    recs = jax_logging.read_metrics(path, kind="train_step")
    assert len(recs) == 1 and recs[0]["loss"] == 0.5 and recs[0]["step"] == 1


def test_read_metrics_equals_the_original(tmp_path):
    """The copied ``read_metrics``: every record, and each kind alone, of a
    log written by the port's logger (blank lines skipped)."""
    path = str(tmp_path / "metrics.jsonl")
    with logging.MetricsLogger(path) as log:
        for e in range(3):
            log.log("epoch", epoch=e, loss=1.0 / (e + 1), valid=float("nan") if e == 1 else 0.5)
            log.log("objective", epoch=e, mcd_db=np.float32(5.0 - e))
    with open(path, "a") as f:
        f.write("\n")
    for kind in (None, "epoch", "objective", "absent"):
        got, want = logging.read_metrics(path, kind), jax_logging.read_metrics(path, kind)
        assert json.dumps(got) == json.dumps(want)
    assert [r["epoch"] for r in logging.read_metrics(path, "epoch")] == [0, 1, 2]


def test_curves_copy_draws_the_originals_png(tmp_path):
    """The copied ``utils/curves.py``: the same metrics log drawn by both
    packages gives the same PNG, byte for byte; no epoch record raises in
    both."""
    path = str(tmp_path / "metrics.jsonl")
    with logging.MetricsLogger(path) as log:
        for e in range(4):
            log.log("epoch", epoch=e, loss=1.0 / (e + 1), valid=0.8 - 0.1 * e,
                    w_dist=0.1 * e, gp=0.05)
    mine = curves.plot_curves(path, str(tmp_path / "mine.png"))
    theirs = jax_curves.plot_curves(path, str(tmp_path / "theirs.png"))
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert curves.plot_curves(path) == str(tmp_path / "curves.png")
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    for pkg in (curves, jax_curves):
        with pytest.raises(ValueError, match="no epoch records"):
            pkg.plot_curves(empty)


@pytest.mark.parametrize("bands", [9, 17, 33, 65, 80])
def test_warp_matrices_equal_the_originals(bands):
    """The copied ``ops/warp.py``: band centres, the warp and the unwarp
    matrices, the mel filterbank and its pseudo-inverse, bit for bit, at
    the vocoders' shapes (80 mels at 1024 points and 16 kHz: config 4's)
    and at small ones."""
    for fs, dftlen in ((16000, 1024), (22050, 2048)):
        np.testing.assert_array_equal(warp._band_centers_hz(bands, fs), jax_warp._band_centers_hz(bands, fs))
        for name in ("warp_matrix", "unwarp_matrix", "mel_weights", "mel_pinv"):
            got = getattr(warp, name)(bands, dftlen, fs)
            want = getattr(jax_warp, name)(bands, dftlen, fs)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)



def test_dataset_and_prefetch_copies_agree_with_the_originals():
    """The copied ``data/dataset.py`` (batch assembly in numpy) and
    ``utils/prefetch.py``: one shuffled, cropped and padded epoch through
    the prefetch thread of each, bit for bit. ``tests/test_torch_dataset.py``
    holds them case by case."""
    rng = np.random.default_rng(2)
    labs = [rng.normal(size=(n, 6)).astype(np.float32) for n in (9, 40, 75, 3, 61, 130)]
    cmps = [rng.normal(size=(a.shape[0], 4)).astype(np.float32) for a in labs]
    kw = dict(shuffle=True, seed=5, drop_remainder=False, epoch=2)
    mine = list(prefetch.prefetch(dataset.Dataset(labs, cmps).batches(4, (32, 64), **kw)))
    theirs = list(jax_prefetch.prefetch(jax_dataset.Dataset(labs, cmps).batches(4, (32, 64), **kw)))
    assert len(mine) == len(theirs) == 2
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_demo_copy_is_the_original_but_its_imports_and_docstring():
    """``data/demo.py`` is copied whole: past its module docstring, its
    source differs from the original's only where the original imports the
    JAX package (``tests/test_torch_demo_compose.py`` holds its output
    byte for byte)."""
    def body(path):
        with open(os.path.join(REPO, path)) as f:
            src = f.read()
        return src[src.index('"""', 3) + 3:].splitlines()

    mine, theirs = body("percivaltts_tpu_torch/data/demo.py"), body("percivaltts_tpu/data/demo.py")
    assert len(mine) == len(theirs)
    differ = [(a, b) for a, b in zip(mine, theirs) if a != b]
    assert len(differ) == 2
    for a, b in differ:
        assert a == b.replace("percivaltts_tpu.", "percivaltts_tpu_torch.")
