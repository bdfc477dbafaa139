"""The port's device corpus (``data/device_corpus.py``) and the trainer's
device-corpus epochs and objective-measure validation against the JAX
package's.

On the CPU (the corpus lives on the CPU device here; the card tests in
``tests/test_torch_cuda.py`` gather on the card):

* ``epoch_indices`` bit for bit over epochs, step counts and group sizes;
* the padded and cropped corpus bit for bit, in f32 and bf16, and the bf16
  cast bit for bit with ``ml_dtypes`` (NaN, ±inf, subnormals and ties
  included);
* the gather and the step wrappers' batches;
* ``shard_corpus`` without a mesh raises the JAX class's error; over a
  mesh each rank gathers its index columns (the mesh layouts are held
  against JAX's in ``tests/test_torch_parallel.py``);
* 2 LSE epochs with ``device_corpus=True`` and ``measures_every=1``,
  selecting on MCD, against the JAX ``Trainer``: the epoch records at
  ``tests/test_torch_loop.py``'s tolerance (rtol 1e-5: f32 sums in another
  order, which Adam can amplify for a gradient at rounding level), the
  objective records at rtol 1e-5 (the voicing error, a count of
  decisions, exactly), the retained checkpoints and their scores;
* a WGAN-GP epoch on the device corpus selecting on ``mcd_gv``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.data import device_corpus as jdc
from percivaltts_tpu.data.dataset import Dataset as JaxDataset
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.training import Trainer as JaxTrainer
from percivaltts_tpu.training import loop as jax_loop
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data import device_corpus as dc
from percivaltts_tpu_torch.data.dataset import Dataset
from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.parallel.mesh import Mesh
from percivaltts_tpu_torch.training import Trainer

L, F = 13, 27  # _tiny_cfg's label dim and features (1 + 17 + 9)


def _utts(n, seed, lengths=(20, 90)):
    """Normalized utterances: labels N(0, 1), targets a fixed linear map of
    them, the nm stream (the last 9) in [0, 1] as compose leaves it."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(L, F)).astype(np.float32) * 0.3
    labs, cmps = [], []
    for _ in range(n):
        x = rng.normal(size=(int(rng.integers(*lengths)), L)).astype(np.float32)
        c = (x @ W).astype(np.float32)
        c[:, -9:] = 1.0 / (1.0 + np.exp(-c[:, -9:]))
        labs.append(x)
        cmps.append(c)
    return labs, cmps


@pytest.mark.parametrize("batch_size,group,num_steps", [(4, 1, 0), (3, 3, 0), (4, 1, 9),
                                                        (5, 6, 2), (30, 1, 0)])
def test_epoch_indices_equal_the_jax_ones(batch_size, group, num_steps):
    """One pass, several steps past the corpus (re-shuffled), groups that
    leave a tail, and a batch larger than the corpus."""
    labs, cmps = _utts(23, seed=0)
    mine = dc.DeviceCorpus(Dataset(labs, cmps), bound=64, device="cpu")
    theirs = jdc.DeviceCorpus(JaxDataset(labs, cmps), bound=64)
    for epoch in range(4):
        got = list(mine.epoch_indices(batch_size, group, epoch, seed=7, num_steps=num_steps))
        want = list(theirs.epoch_indices(batch_size, group, epoch, seed=7, num_steps=num_steps))
        assert len(got) == len(want) == (num_steps or max(23 // (batch_size * group), 1))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32 and g.shape == (group, batch_size)
            np.testing.assert_array_equal(g, w)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_cropped_corpus_equals_the_jax_one(dtype):
    """Utterances shorter and longer than the bound (one seeded crop each)."""
    labs, cmps = _utts(9, seed=1, lengths=(10, 120))
    mine = dc.DeviceCorpus(Dataset(labs, cmps), bound=64, dtype=dtype, device="cpu")
    theirs = jdc.DeviceCorpus(JaxDataset(labs, cmps), bound=64, dtype=dtype)
    assert any(x.shape[0] > 64 for x in labs) and any(x.shape[0] < 64 for x in labs)
    for k in ("lab", "cmp", "mask"):
        got, want = mine.data[k], np.asarray(theirs.data[k])
        assert got.shape == want.shape
        if k == "mask" or dtype == "float32":
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(_bits(got), want.view(np.uint16))
    assert mine.nbytes == sum(np.asarray(v).nbytes for v in theirs.data.values())


def test_bf16_cast_is_ml_dtypes_bit_for_bit():
    """Round to nearest even, NaN (both signs, several payloads: each the
    quiet NaN of its sign), ±inf, overflow to inf, subnormals, exact ties,
    and random values."""
    u32 = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF, 0xFF800123, 0x7F800000,
                    0xFF800000, 0x7F7FFFFF, 0x00000001, 0x80000001, 0x007FFFFF, 0x3F808000,
                    0x3F818000, 0xBF808000, 0x3F80FFFF, 0x00000000, 0x80000000], np.uint32)
    x = np.concatenate([u32.view(np.float32),
                        np.random.default_rng(2).normal(size=4096).astype(np.float32) * 1e3])
    got = _bits(dc.to_bfloat16(x))
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(x).sum() == 5 and np.isinf(x).sum() == 2


def test_gather_and_step_wrappers_give_the_jax_batches():
    labs, cmps = _utts(11, seed=3)
    mine = dc.DeviceCorpus(Dataset(labs, cmps), bound=96, device="cpu")
    theirs = jdc.DeviceCorpus(JaxDataset(labs, cmps), bound=96)
    idx = next(mine.epoch_indices(3, 3, 0, seed=1))
    got = dc.gather_batch(mine.data, mine.shard_indices(idx))
    want = jdc.gather_batch(theirs.data, theirs.shard_indices(idx))
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    seen = {}
    record = lambda tag: lambda state, *b: seen.setdefault(tag, b) and (state, {})  # noqa: E731
    dc.make_device_wgan_step(record("wgan"), n_critic=2)(None, mine.data, torch.from_numpy(idx))
    jdc.make_device_wgan_step(record("jwgan"), n_critic=2)(None, theirs.data, idx)
    dc.make_device_lse_step(record("lse"))(None, mine.data, torch.from_numpy(idx[:1]))
    jdc.make_device_lse_step(record("jlse"))(None, theirs.data, idx[:1])
    for tag in ("wgan", "lse"):
        assert len(seen[tag]) == len(seen["j" + tag])
        for b, jb in zip(seen[tag], seen["j" + tag]):
            for k in ("lab", "cmp", "mask"):
                assert b[k].shape == jb[k].shape
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def test_mesh_and_sharded_corpus_raise_naming_their_roadmap_item():
    """A corpus sharded over no mesh raises the JAX class's ValueError. Over
    a mesh (row slicing needs no process group) the replicated corpus
    holds every utterance and each rank gathers its columns of the index
    arrays."""
    labs, cmps = _utts(5, seed=4)
    with pytest.raises(ValueError) as want:
        jdc.DeviceCorpus(JaxDataset(labs, cmps), bound=64, shard_corpus=True)
    with pytest.raises(ValueError) as got:
        dc.DeviceCorpus(Dataset(labs, cmps), bound=64, device="cpu", shard_corpus=True)
    assert str(got.value) == str(want.value) == "shard_corpus=True requires a mesh"
    idx = np.arange(12, dtype=np.int32).reshape(3, 4) % 5
    for rank in range(2):
        corpus = dc.DeviceCorpus(Dataset(labs, cmps), bound=64, device="cpu",
                                 mesh=Mesh(rank=rank, size=2))
        assert corpus.data["lab"].shape[0] == 5
        np.testing.assert_array_equal(corpus.shard_indices(idx).numpy(),
                                      idx[:, 2 * rank:2 * rank + 2])


# --- the trainer on the device corpus ------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_init():
    """The JAX Trainer's state under jit: half the time of flax's eager init."""
    jitted = jax.jit(jax_loop.make_gan_state, static_argnums=(0, 1, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "make_gan_state",
                   lambda cfg, label_dim, seed=None, mesh=None: jitted(cfg, label_dim, seed, mesh))
        yield


OUT_STATS = dict(shift=np.concatenate([np.full(F - 9, -0.5), np.zeros(9)]).astype(np.float32),
                 scale=np.concatenate([np.full(F - 9, 2.0), np.ones(9)]).astype(np.float32))


def _cfgs(workdir, trainer="lse", **train_kw):
    """(JAX config, the port's config): _tiny_cfg with the FC generator, f32."""
    cfg = _tiny_cfg(trainer)
    cfg = cfg.replace(
        workdir=str(workdir),
        data=dataclasses.replace(cfg.data, batch_size=4, bucket_bounds=(48, 96)),
        model=dataclasses.replace(cfg.model, generator="fc", num_layers=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, device_corpus=True, **train_kw),
    )
    return cfg, Configuration.from_dict(cfg.to_dict())


def _records(workdir, kind):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_device_corpus_lse_epochs_with_measures_match_the_jax_trainer(tmp_path):
    """26 training utterances of 20–89 frames (cropped to nothing: the
    bound is 96): 6 steps of 4 an epoch, with 2 utterances left out of each
    pass; 5 validation utterances; EMA 0.9; MCD selects the best."""
    jcfg, cfg = _cfgs("unused", ema_decay=0.9, lr_gen=1e-3, measures_every=1,
                      best_metric="mcd", keep_checkpoints=1)
    train, valid = _utts(26, seed=5), _utts(5, seed=6)
    jt = JaxTrainer(jcfg, JaxDataset(*train), JaxDataset(*valid), workdir=str(tmp_path / "jax"),
                    measures_stats=JaxNormStats(**OUT_STATS))
    init = jax.tree.map(lambda a: np.array(a, copy=True), jt.state.gen.params)
    jhist = jt.train(epochs=2)
    jt.close()
    pt = Trainer(cfg, Dataset(*train), Dataset(*valid), workdir=str(tmp_path / "port"),
                 measures_stats=NormStats(**OUT_STATS), device="cpu")
    assert pt.dcorpus is not None and pt.dcorpus.data["lab"].shape == (26, 96, L)
    weights.load_flax_params(pt.state.gen, init)
    pt.state.ema = {n: p.detach().clone() for n, p in pt.state.gen.named_parameters()}
    phist = pt.train(epochs=2)
    pt.close()

    assert [r["steps"] for r in phist["train"]] == [r["steps"] for r in jhist["train"]] == [6, 6]
    pairs = [(p[k], j[k]) for j, p in zip(jhist["train"], phist["train"])
              for k in ("loss", "grad_norm")] + list(zip(phist["valid"], jhist["valid"]))
    mine, theirs = _records(pt.workdir, "objective"), _records(jt.workdir, "objective")
    assert [r["epoch"] for r in mine] == [r["epoch"] for r in theirs] == [0, 1]
    for r, w in zip(mine, theirs):
        assert r["vuv_error_pct"] == w["vuv_error_pct"]
        pairs += [(r[k], w[k]) for k in ("mcd_db", "gv_ratio", "ms_ratio_hi", "f0_rmse_hz")]
    worst = max(abs(got - want) / abs(want) for got, want in pairs)
    print(f"device-corpus LSE epochs and measures, port vs JAX: max relative difference {worst:.3g}")
    assert worst <= 1e-5
    # MCD chose the same checkpoints, scored with the MCD
    steps = jt.ckpt._mgr.all_steps()
    assert pt.ckpt.all_steps() == steps and pt.ckpt.best_step() == jt.ckpt.best_step()
    for s in steps:
        got, want = pt.ckpt.metrics(s), jt.ckpt._mgr.metrics(s)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)
        np.testing.assert_allclose(got["score"], got["mcd_db"], rtol=0)


def test_device_corpus_wgan_epoch_selects_on_mcd_gv(tmp_path):
    """WGAN-GP (n_critic 2) on the device corpus: one epoch of 2 steps of
    3 × 4 utterances, ``mcd_gv`` = MCD + 10·|ln GV ratio| as its score."""
    _, cfg = _cfgs(tmp_path, "wgan", measures_every=1, best_metric="mcd_gv", steps_per_epoch=2,
                   lr_critic=1e-3)
    t = Trainer(cfg, Dataset(*_utts(14, seed=7)), Dataset(*_utts(3, seed=8)),
                measures_stats=NormStats(**OUT_STATS), device="cpu")
    hist = t.train(epochs=1)
    t.close()
    (rec,) = hist["train"]
    assert rec["steps"] == 2 and all(np.isfinite(v) for v in rec.values())
    (obj,) = _records(t.workdir, "objective")
    want = obj["mcd_db"] + 10.0 * abs(np.log(max(obj["gv_ratio"], 1e-6)))
    assert t.ckpt.all_steps() == [0]
    np.testing.assert_allclose(t.ckpt.metrics(0)["score"], want, rtol=1e-12)
    assert t.best_valid == t.ckpt.metrics(0)["score"]
