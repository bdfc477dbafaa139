"""The per-process device corpus (``data/device_corpus.py`` on a mesh
whose ranks stand for processes, ``make_mesh(per_process=True)``) against
the JAX package's ``DeviceCorpus`` in its multi-process branch, on the CPU.

The port's side runs once for the module: two processes
(``tests/torch_per_process_worker.py``) join a gloo group, each given only
its own ``Dataset.shard(2, rank)``. The JAX side runs in this process: the
JAX ``DeviceCorpus`` on each ``Dataset.shard(2, p)`` over a 2-device CPU
mesh, with ``jax.process_count`` / ``jax.process_index``, the count
all-gather and ``jax.make_array_from_process_local_data`` stood in for by
``monkeypatch`` (the all-gather returns both counts, the upload the
process's own rows), so its multi-process branch runs as process ``p``.

* (a) the blocks (f32 and bf16), counts, two epochs' index arrays and each
  rank's columns equal the JAX branch's bit for bit, on 33 utterances
  (shards of 17 and 16, rank 1 padding one row) of which two are cropped;
  one all-gather at construction; they differ from the one-host layout;
* (b) 2 LSE epochs of the ``Trainer`` from the per-process corpus (32
  utterances, equal shards) against the JAX single-process 2-device run on
  the corpus reordered to the shards' assignment, as
  ``tests/distributed_worker.py`` builds it, at ``tests/test_distributed.py``'s
  tolerance (rtol 2e-4); both ranks' states bit-equal; rank 0's sanity
  record is its own shard's;
* (c) ``cli train --distributed`` builds a per-process mesh and ``--mesh``
  a one-host one;
* (d) a rank with an empty shard: every rank raises, naming it.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental import multihost_utils

from percivaltts_tpu.data import device_corpus as jdc
from percivaltts_tpu.data.dataset import Dataset as JaxDataset
from percivaltts_tpu.data.dataset import cost_0pred_rmse as jax_cost_0pred_rmse
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.parallel import make_mesh as jax_make_mesh
from percivaltts_tpu.training import Trainer as JaxTrainer
from percivaltts_tpu.training import loop as jax_loop
from percivaltts_tpu_torch import cli
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset
from percivaltts_tpu_torch.data.device_corpus import DeviceCorpus
from percivaltts_tpu_torch.parallel import distributed
from percivaltts_tpu_torch.parallel.mesh import Mesh
from test_torch_loop import IN_STATS, OUT_STATS, _corpus, _records, _shared_cfgs
from test_torch_loop import _state_dicts_equal

WORKER = os.path.join(os.path.dirname(__file__), "torch_per_process_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BOUND = 64
LONG = {1: 100, 4: 130}  # utterances longer than BOUND: one in each shard


def _blocks_case():
    labs, cmps = _corpus(33, seed=31, lengths=(20, 60))
    rng = np.random.default_rng(32)
    for i, n in LONG.items():
        labs[i] = rng.normal(size=(n, labs[i].shape[1])).astype(np.float32)
        cmps[i] = rng.normal(size=(n, cmps[i].shape[1])).astype(np.float32)
    return {"labs": labs, "cmps": cmps, "bound": BOUND, "batch_size": 4, "group": 3, "seed": 5}


def _trainer_cfg(root):
    tcfg = _shared_cfgs()[0]
    return tcfg.replace(
        workdir=str(root / "jax"),
        model=dataclasses.replace(tcfg.model, generator="fc", num_layers=2),
        train=dataclasses.replace(tcfg.train, device_corpus=True, shard_corpus=True))


def _jax_trainer(cfg, train, valid):
    """The JAX single-process run over 2 devices on the training corpus
    reordered to the 2 shards' assignment (tests/distributed_worker.py):
    its contiguous blocks hold the utterances of each process's shard."""
    order = list(range(0, len(train[0]), 2)) + list(range(1, len(train[0]), 2))
    jitted = jax.jit(jax_loop.make_gan_state, static_argnums=(0, 1, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "make_gan_state",
                   lambda cfg, label_dim, seed=None, mesh=None: jitted(cfg, label_dim, seed, mesh))
        return JaxTrainer(cfg, JaxDataset([train[0][i] for i in order],
                                          [train[1][i] for i in order]),
                          JaxDataset(*valid), mesh=jax_make_mesh(data_parallel=WORLD),
                          workdir=cfg.workdir, in_stats=JaxNormStats(**IN_STATS),
                          out_stats=JaxNormStats(**OUT_STATS))


def _jax_blocks(case, dtype):
    """The JAX DeviceCorpus's multi-process branch as each of 2 processes,
    each given its Dataset.shard: [{data, num_utts, num_utts_padded, idx,
    local}] by process."""
    shards = [JaxDataset(case["labs"], case["cmps"]).shard(WORLD, p) for p in range(WORLD)]
    counts = np.array([len(s) for s in shards], np.int32)
    mesh = jax_make_mesh(data_parallel=WORLD)
    out = []
    for p, ds in enumerate(shards):
        def allgather(x, p=p):
            assert int(x) == counts[p]
            return counts

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "process_count", lambda: WORLD)
            mp.setattr(jax, "process_index", lambda p=p: p)
            mp.setattr(multihost_utils, "process_allgather", allgather)
            mp.setattr(jax, "make_array_from_process_local_data",
                       lambda sharding, local, global_shape=None: np.asarray(local))
            jc = jdc.DeviceCorpus(ds, bound=case["bound"], dtype=dtype, mesh=mesh,
                                  shard_corpus=True)
            idx = [list(jc.epoch_indices(case["batch_size"], case["group"], e,
                                         seed=case["seed"])) for e in range(2)]
            local = [[np.asarray(jc.shard_indices(i)) for i in e] for e in idx]
        bits = {k: (v.view(np.int16) if v.dtype.itemsize == 2 else v)
                for k, v in jc.data.items()}
        out.append({"data": bits, "num_utts": jc.num_utts,
                    "num_utts_padded": jc.num_utts_padded, "idx": idx, "local": local})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs, the JAX references, each rank's results, the root)."""
    root = tmp_path_factory.mktemp("per_process")
    train, valid = _corpus(32, seed=33), _corpus(7, seed=34)
    cfg = _trainer_cfg(root)
    jt = _jax_trainer(cfg, train, valid)
    cases = {"blocks": _blocks_case(),
             "trainer": {"cfg": cfg.to_dict(), "train": train, "valid": valid,
                         "gen": jax.tree.map(np.asarray, jt.state.gen.params),
                         "in_stats": IN_STATS, "out_stats": OUT_STATS}}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **torch_threads.ENV)
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               str(root / "inputs.pkl"), str(root)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        ref = {dtype: _jax_blocks(cases["blocks"], dtype) for dtype in ("float32", "bfloat16")}
        ref["trainer_hist"] = jt.train(epochs=2)
        jt.close()
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (root / f"rank{r}.log").read_text()[-4000:]
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return cases, ref, ranks, root


# --- (a) the blocks and the index arrays --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_equal_the_jax_multi_process_branch(runs, dtype):
    cases, ref, ranks, _ = runs
    assert [r["per_process"] for r in ranks] == [True, True]
    for r, rank in enumerate(ranks):
        got, want = rank["blocks"][dtype], ref[dtype][r]
        for k in ("lab", "cmp", "mask"):
            np.testing.assert_array_equal(got["data"][k], want["data"][k], err_msg=k)
        assert (got["num_utts"], got["num_utts_padded"]) == \
            (want["num_utts"], want["num_utts_padded"]) == ((17, 16)[r], 34)
        assert got["data"]["lab"].shape[0] == 17 and got["all_gathers"] == 1
    # the padded row of rank 1 repeats its first utterance (global 1, cropped)
    # with a crop of its own
    block = ranks[1]["blocks"]["float32"]["data"]
    assert block["mask"][16].sum() == block["mask"][0].sum() == BOUND
    assert not np.array_equal(block["lab"][16], block["lab"][0])


def test_index_arrays_and_rank_columns_equal_the_jax_branch(runs):
    cases, ref, ranks, _ = runs
    for r, rank in enumerate(ranks):
        got, want = rank["blocks"]["float32"], ref["float32"][r]
        assert [len(e) for e in got["idx"]] == [len(e) for e in want["idx"]] == [2, 2]
        for ge, we, gl, wl in zip(got["idx"], want["idx"], got["local"], want["local"]):
            for g, w, lg, lw in zip(ge, we, gl, wl):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(lg, lw)
                assert lg.shape == (cases["blocks"]["group"], 2) and lg.max() < 17


def test_per_process_blocks_differ_from_the_one_host_layout(runs):
    """The same corpus laid out for one process's devices (every rank
    reading the whole corpus) gives other blocks: the layouts are not
    interchangeable."""
    cases, ref, ranks, _ = runs
    c = cases["blocks"]
    ds = Dataset(c["labs"], c["cmps"])
    for r, rank in enumerate(ranks):
        one_host = DeviceCorpus(ds, bound=c["bound"], mesh=Mesh(rank=r, size=WORLD),
                                shard_corpus=True, device="cpu")
        assert one_host.num_utts_padded == 34 and one_host.data["lab"].shape[0] == 17
        assert not np.array_equal(one_host.data["lab"].numpy(),
                                  rank["blocks"]["float32"]["data"]["lab"])


# --- (b) a trajectory ------------------------------------------------------------------


def test_trainer_epochs_match_the_jax_run_on_the_reordered_corpus(runs):
    cases, ref, ranks, _ = runs
    jhist = ref["trainer_hist"]
    for rank in ranks:
        t = rank["trainer"]
        assert t["corpus"] == (16, 32, 16)
        phist = t["hist"]
        assert [r["steps"] for r in phist["train"]] == [r["steps"] for r in jhist["train"]] \
            == [8, 8]
        pairs = [(p[k], j[k]) for j, p in zip(jhist["train"], phist["train"])
                 for k in ("loss", "grad_norm")] + list(zip(phist["valid"], jhist["valid"]))
        for got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=2e-4)
    _state_dicts_equal(ranks[0]["trainer"]["state"], ranks[1]["trainer"]["state"])


def test_rank_0_records_its_own_shard(runs):
    """The sanity record is rank 0's own shard's zero-predictor RMSE, as the
    JAX package's process 0 records its own; two epoch records."""
    cases, ref, ranks, root = runs
    train = cases["trainer"]["train"]
    want = jax_cost_0pred_rmse(JaxDataset(*train).shard(WORLD, 0).cmps)
    sanity = _records(root / "trainer", "sanity")
    assert len(sanity) == 1 and sanity[0]["cost_0pred_rmse"] == pytest.approx(want, rel=1e-6)
    assert len(_records(root / "trainer", "epoch")) == 2


# --- (c) the CLI -----------------------------------------------------------------------


def test_cli_distributed_builds_a_per_process_mesh(tmp_path):
    """``train --distributed`` lays the ranks out as the JAX package's
    processes, ``--mesh`` as one process's devices; without either, no
    mesh. In a gloo group of one (no training run)."""
    distributed.initialize(f"file://{tmp_path / 'group'}", 1, 0, "gloo")
    try:
        cfg, parser = Configuration(), cli._parser()
        meshes = {flag: cli._train_mesh(parser.parse_args(["train", "--config", "c.json", flag]
                                                          if flag else
                                                          ["train", "--config", "c.json"]),
                                        cfg, torch.device("cpu"))
                  for flag in ("--mesh", "--distributed", "")}
    finally:
        dist.destroy_process_group()
    assert meshes[""] is None
    assert meshes["--mesh"].per_process is False and meshes["--distributed"].per_process is True
    assert meshes["--distributed"].shape == meshes["--mesh"].shape == {"data": 1, "model": 1}


# --- (d) an empty shard -----------------------------------------------------------------


def test_a_rank_with_no_utterances_raises_on_every_rank(runs):
    ranks = runs[2]
    for rank in ranks:
        assert rank["empty"] is not None and "rank(s) [1]" in rank["empty"]
        assert "counts [1, 0]" in rank["empty"]
