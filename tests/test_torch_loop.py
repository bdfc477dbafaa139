"""The port's training loop (``training/loop.py``) against the JAX
package's ``Trainer``.

Tiny widths (``__graft_entry__._tiny_cfg``, f32 compute), on the CPU:

* the WGAN batch grouping, over three epochs with carried partial groups;
* the control logic (best metric, patience, which epochs are saved, the
  final save, what ``resume()`` re-seeds) on scripted validation scores;
* the numbers: one 2-epoch LSE run of each trainer from the same weights
  on the same raw data, normalized on the device, epoch by epoch;
* resume: 2 epochs in one run equal, bit for bit, 1 epoch, a fresh
  ``Trainer``, ``resume()`` and 1 more;
* the options the Trainer refuses (a corpus sharded over no mesh, a batch
  that does not split over the mesh, a measure-driven best checkpoint
  without the measures). The Trainer under a mesh is held against the JAX
  one in ``tests/test_torch_parallel.py``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.data.dataset import Dataset as JaxDataset
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.training import Trainer as JaxTrainer
from percivaltts_tpu.training import loop as jax_loop
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset
from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.parallel.mesh import Mesh
from percivaltts_tpu_torch.training import Trainer
from percivaltts_tpu_torch.training import loop

L, F = 13, 27  # _tiny_cfg's label dim and features (1 + 17 + 9)


def _cfgs(trainer="lse", workdir="exp/t", **train_kw):
    """(JAX config, the port's config): _tiny_cfg in f32 with ``train_kw``."""
    cfg = _tiny_cfg(trainer)
    cfg = cfg.replace(
        workdir=str(workdir),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train_kw),
    )
    return cfg, Configuration.from_dict(cfg.to_dict())


def _corpus(n, seed, lengths=(20, 90)):
    """Raw utterances: labels and targets a fixed affine map of N(0,1)
    normalized values (so the model has something to learn)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(L, F)).astype(np.float32) * 0.3
    labs, cmps = [], []
    for _ in range(n):
        x = rng.normal(size=(int(rng.integers(*lengths)), L)).astype(np.float32)
        labs.append(x * 2.0 + 1.0)
        cmps.append(((x @ W) / 0.5 - 0.25).astype(np.float32))
    return labs, cmps


# one config for every JAX trainer here (the JAX init compiles once per
# config); each trainer gets its own workdir through ``workdir=``. 24
# training utterances of 20–89 frames give 6 batches of 4 an epoch in the
# 48- and 96-frame buckets.
SHARED = dict(ema_decay=0.9, profile_steps=1, lr_gen=1e-3, checkpoint_every=3, patience=3,
              keep_checkpoints=2)


def _shared_cfgs():
    jcfg, cfg = _cfgs("lse", "exp/unused", **SHARED)
    data = dict(batch_size=4, bucket_bounds=(48, 96))
    return (jcfg.replace(data=dataclasses.replace(jcfg.data, **data)),
            cfg.replace(data=dataclasses.replace(cfg.data, **data)))


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_init():
    """The JAX Trainer builds its state with flax's eager init; the same
    function under jit builds the same state in half the time."""
    jitted = jax.jit(jax_loop.make_gan_state, static_argnums=(0, 1, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "make_gan_state",
                   lambda cfg, label_dim, seed=None, mesh=None: jitted(cfg, label_dim, seed, mesh))
        yield


IN_STATS = dict(shift=np.full(L, 1.0, np.float32), scale=np.full(L, 0.5, np.float32))
OUT_STATS = dict(shift=np.full(F, -0.25, np.float32), scale=np.full(F, 0.5, np.float32))


def _records(workdir, kind):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


# --- the WGAN batch grouping -------------------------------------------------


def test_wgan_grouping_equals_the_jax_grouping_across_epochs():
    """Epoch 1 fills one group of the 32-frame bucket and leaves partial
    groups in both; epoch 2 adds too few batches for any group (a zero-step
    epoch); epoch 3 completes the carried groups of both. Groups of 3."""
    rng = np.random.default_rng(0)

    def batch(bound):
        return {"lab": rng.normal(size=(2, bound, 3)).astype(np.float32),
                "mask": rng.random((2, bound)).astype(np.float32)}

    epochs = [[batch(32), batch(64), batch(32), batch(32), batch(32), batch(64)],
              [batch(32)],
              [batch(64), batch(64), batch(32), batch(64)]]
    mine, theirs = {}, {}
    steps = []
    for batches in epochs:
        got = list(loop._group_wgan_batches(iter(batches), 3, mine))
        steps.append(len(got))
        want = list(jax_loop._group_wgan_batches(iter(batches), 3, theirs))
        assert len(got) == len(want)
        for (gc, gg), (wc, wg) in zip(got, want):
            assert gc.keys() == wc.keys()
            for k in gc:
                np.testing.assert_array_equal(gc[k], wc[k])
                np.testing.assert_array_equal(gg[k], wg[k])
        assert {b: len(v) for b, v in mine.items()} == {b: len(v) for b, v in theirs.items()}
        for bound in mine:
            assert all(x is y for x, y in zip(mine[bound], theirs[bound]))
    # the carried batches close two groups in epoch 3 (alone it closes one)
    assert steps == [1, 0, 2]
    assert {b: len(v) for b, v in mine.items()} == {32: 0, 64: 2}


# --- the control logic on scripted scores ------------------------------------

# improving, NaN (no score: not an improvement, not a stale evaluation),
# a tie, a plateau that runs out the patience
SCORES = [5.0, 4.0, float("nan"), 4.5, 3.0, 3.0, float("nan"), 3.2, 3.1, 3.5, 2.0]
# after the resume: one improvement, then a plateau to the stop
SCORES_AFTER = [2.5, 1.5, 1.6, float("nan"), 1.7, 1.8, 1.9, 0.1]


def _scripted(trainer, scores):
    """Replace a trainer's epoch and validation with scripted results."""
    it = iter(scores)
    trainer._train_epoch = lambda epoch: {"loss": float(epoch), "steps": 1, "sec": 0.0,
                                          "frames_per_sec": 1.0}
    trainer._validate = lambda: next(it)
    return trainer


def _control_state(t):
    mgr = getattr(t.ckpt, "_mgr", t.ckpt)  # Orbax's manager, or the port's
    steps = list(mgr.all_steps())
    return {"steps": steps, "metrics": {s: mgr.metrics(s) for s in steps},
            "best": (t.best_epoch, t.best_valid), "stale": t._stale_evals,
            "epoch": int(t.state.epoch), "best_step": t.ckpt.best_step()}


def test_control_logic_equals_the_jax_trainer(tmp_path):
    """checkpoint_every=3 (so saves come from improvements, the period and
    the final save), patience 3, 2 checkpoints kept: the saved steps and
    their metrics, the stop epoch, best_epoch/best_valid; then a fresh
    trainer of each resumes (re-seeding the best from the retained
    checkpoints) and runs on to its next stop."""
    jcfg, cfg = _shared_cfgs()
    ds = _corpus(8, seed=1)
    jds, pds = JaxDataset(*ds), Dataset(*ds)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")

    runs = {}
    for name, make in (("jax", lambda: JaxTrainer(jcfg, jds, jds, workdir=jdir)),
                       ("port", lambda: Trainer(cfg, pds, pds, workdir=pdir, device="cpu"))):
        t = _scripted(make(), SCORES)
        hist = t.train(epochs=20)
        first = _control_state(t), len(hist["valid"]), hist["valid"]
        t.close()
        t = _scripted(make(), SCORES_AFTER)
        assert t.resume()
        resumed = _control_state(t)
        hist = t.train(epochs=20)
        runs[name] = (first, resumed, (_control_state(t), len(hist["valid"])))
        t.close()
    jax_run, port_run = runs["jax"], runs["port"]
    np.testing.assert_array_equal(port_run[0][2], jax_run[0][2])
    assert port_run[0][:2] == jax_run[0][:2]
    assert port_run[1:] == jax_run[1:]
    # the scripts end where the patience runs out, not where they run out
    assert port_run[0][1] == 9 and port_run[2][1] == 6


# --- the numbers: an LSE run of each trainer ---------------------------------


@pytest.fixture(scope="module")
def lse_runs(tmp_path_factory):
    """One JAX Trainer run and one port Trainer run, 2 epochs of LSE from
    the same initial weights on the same raw data (24 training utterances:
    6 batches of 4 an epoch in 2 buckets; 7 validation utterances: the last
    batch of each bucket padded), normalized on the device, EMA on,
    profiling one step of the second epoch."""
    root = tmp_path_factory.mktemp("lse")
    jcfg, cfg = _shared_cfgs()
    train, valid = _corpus(24, seed=2), _corpus(7, seed=3)
    jt = JaxTrainer(jcfg, JaxDataset(*train), JaxDataset(*valid), workdir=str(root / "jax"),
                    in_stats=JaxNormStats(**IN_STATS), out_stats=JaxNormStats(**OUT_STATS))
    init = jax.tree.map(lambda a: np.array(a, copy=True), jt.state.gen.params)
    jhist = jt.train(epochs=2)
    jt.close()
    pt = Trainer(cfg, Dataset(*train), Dataset(*valid), workdir=str(root / "port"),
                 in_stats=NormStats(**IN_STATS), out_stats=NormStats(**OUT_STATS), device="cpu")
    weights.load_flax_params(pt.state.gen, init)
    pt.state.ema = {n: p.detach().clone() for n, p in pt.state.gen.named_parameters()}
    phist = pt.train(epochs=2)
    pt.close()
    return jhist, phist, jt, pt


def test_lse_epochs_match_the_jax_trainer(lse_runs):
    """Each epoch's mean loss and gradient norm, and the validation MSE.
    Tolerance rtol 1e-5. The two runs differ only by f32 rounding (sums in
    another order), which Adam can amplify: its update lr·m̂/(√v̂ + eps) is
    close to lr·sign(g) for a gradient near rounding level, so such a
    weight can move by lr (1e-3 here) in one framework and not the other.
    Seen on the CPU: 1.4e-7 at most over the 12 steps (printed, with
    ``-s``), so no such flip reached these numbers; 1e-5 leaves room for a
    few."""
    jhist, phist, _, _ = lse_runs
    pairs = [(p[k], j[k]) for j, p in zip(jhist["train"], phist["train"])
             for k in ("loss", "grad_norm")] + list(zip(phist["valid"], jhist["valid"]))
    worst = max(abs(got - want) / abs(want) for got, want in pairs)
    print(f"LSE epochs, port vs JAX: max relative difference {worst:.3g}")
    assert [r["steps"] for r in phist["train"]] == [r["steps"] for r in jhist["train"]] == [6, 6]
    assert worst <= 1e-5
    assert phist["train"][1]["loss"] < phist["train"][0]["loss"]


def test_lse_run_writes_the_jax_trainers_records(lse_runs):
    """config.json, metrics.jsonl (system, sanity, epoch records with the
    step timings), the same checkpoints, and a Chrome trace of the profiled
    step."""
    _, _, jt, pt = lse_runs
    assert pt.ckpt.all_steps() == jt.ckpt._mgr.all_steps() == [0, 1]
    assert pt.ckpt.best_step() == jt.ckpt.best_step()
    for t in (jt, pt):
        assert os.path.exists(os.path.join(t.workdir, "config.json"))
    (sanity,) = _records(pt.workdir, "sanity")
    (jsanity,) = _records(jt.workdir, "sanity")
    assert sanity["cost_0pred_rmse"] == jsanity["cost_0pred_rmse"]
    (system,) = _records(pt.workdir, "system")
    assert system["platform"] == "cpu" and system["torch"] == torch.__version__
    epochs = _records(pt.workdir, "epoch")
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(r["step_mean_s"] > 0 and r["step_max_s"] >= r["step_mean_s"] for r in epochs)
    traces = os.listdir(os.path.join(pt.workdir, "traces"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(pt.workdir, "traces", traces[0])) as f:
        assert json.load(f)["traceEvents"]


# --- resume ----------------------------------------------------------------


def _state_dicts_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _state_dicts_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _state_dicts_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("trainer", ["lse", "wgan"])
def test_resumed_run_equals_an_uninterrupted_run(tmp_path, trainer):
    """Dropout on and an EMA, so the step generator and the EMA must come
    back too. The WGAN corpus gives 6 batches of one bucket an epoch, 2
    whole groups of 3: no partial group is carried over the epoch boundary
    (those are not checkpointed, as in the JAX trainer)."""
    _, cfg = _cfgs(trainer, tmp_path / "whole", ema_decay=0.9, lr_gen=1e-3, lr_critic=1e-3)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.2),
                      data=dataclasses.replace(cfg.data, batch_size=4))
    train, valid = Dataset(*_corpus(24, seed=4, lengths=(20, 64))), Dataset(*_corpus(3, seed=5))

    whole = Trainer(cfg, train, valid, device="cpu")
    hist = whole.train(epochs=2)
    whole.close()
    assert [r["steps"] for r in hist["train"]] == ([6, 6] if trainer == "lse" else [2, 2])

    split_cfg = cfg.replace(workdir=str(tmp_path / "split"))
    first = Trainer(split_cfg, train, valid, device="cpu")
    first.train(epochs=1)
    first.close()
    second = Trainer(split_cfg, train, valid, device="cpu")
    assert second.resume() and second.state.epoch == 1
    hist2 = second.train(epochs=2)
    second.close()
    assert hist2["train"][0]["loss"] == hist["train"][1]["loss"]
    assert hist2["valid"] == hist["valid"][1:]
    _state_dicts_equal(second.state.state_dict(), whole.state.state_dict())


# --- what waits ------------------------------------------------------------


def test_unported_options_raise_naming_their_roadmap_item(tmp_path):
    """The options the Trainer refuses, with the JAX Trainer's messages: a
    corpus sharded over no mesh, a batch that does not split over the
    mesh's ranks (the refusals come before any collective: the mesh needs
    no process group), and a measure-driven best checkpoint without the
    measures."""
    _, cfg = _cfgs("lse", tmp_path)
    ds = Dataset(*_corpus(4, seed=6))
    stats = NormStats(**OUT_STATS)
    cases = [
        (dict(cfg=cfg.replace(train=dataclasses.replace(cfg.train, device_corpus=True,
                                                        shard_corpus=True))),
         "shard_corpus=True requires a mesh"),
        (dict(cfg=cfg, mesh=Mesh(rank=0, size=3)),
         r"batch_size 8 must be divisible by the mesh data axis \(3 devices\)"),
    ]
    for kw, message in cases:
        with pytest.raises(ValueError, match=message):
            Trainer(train_ds=ds, device="cpu", **kw)
    # a measure-driven best checkpoint needs the measures and their stats
    for metric in ("mcd", "mcd_gv"):
        bad = cfg.replace(train=dataclasses.replace(cfg.train, best_metric=metric))
        with pytest.raises(ValueError, match="measures_every"):
            Trainer(bad, ds, ds, device="cpu", measures_stats=stats)
        bad = bad.replace(train=dataclasses.replace(bad.train, measures_every=1))
        with pytest.raises(ValueError, match="measures_stats"):
            Trainer(bad, ds, ds, device="cpu")
