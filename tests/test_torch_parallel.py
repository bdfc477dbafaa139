"""The port's data parallelism (``parallel/``, the steps and the Trainer
under a mesh) against the JAX package's 2-device mesh, on the CPU.

The port's world-size-2 side runs once for the module: two processes
(``tests/torch_parallel_worker.py``) join a gloo group through a file under
the module's temporary directory and write what they computed there; the
JAX side runs meanwhile in this process, on 2 of the 8 CPU devices that
``tests/conftest.py`` forces. The world-size-1 cases join a gloo group of
one in this process.

* (a) row slicing: ``make_mesh``'s shape and refusals; ``shard_batch`` and
  ``shard_stacked_batch`` rows for each rank of 2 and 4 against JAX's
  addressable shards;
* (b) world size 1 changes nothing: a WGAN-GP step and an LSE step of the
  FC generator with dropout under a mesh equal the mesh-less steps bit
  for bit;
* (c) world size 2 against JAX's 2-device mesh: an LSE step of the FC
  generator and a WGAN-GP step of the tiny CNN+BiLSTM generator (every
  step option on, ε handed over), at ``tests/test_torch_training.py``'s
  tolerances (metrics rtol 1e-4, parameters atol 1e-6 where the gradient is
  above 1e-4 of its parameter's max); both ranks' states bit-equal;
* dropout at world size 2: a WGAN-GP step and an LSE step of the FC
  generator with dropout, each rank drawing ε and the masks at the global
  shape from the state's generator, against the same steps without a
  mesh in this process (f32: metrics rtol 1e-5, the adversarial ones with
  the critic's score bias added back; parameters atol 1e-6 where the
  gradient is above 1e-4 of its parameter's max);
* (d) the global denominator: the LSE step on a batch whose second half
  has zero masks (``Dataset.batches``' padding rows, all on rank 1), which
  a per-rank denominator would miss by more than the tolerance;
* (e) the device corpus, replicated and ``shard_corpus=True``: each rank's
  block and index columns against JAX's, and one step gathered from the
  sharded corpus against JAX's ``make_device_lse_step(sharded_mesh=…)``;
* (f) the Trainer: 2 LSE epochs of the FC generator, normalized on the
  device, against the JAX ``Trainer(mesh=…)`` at
  ``tests/test_torch_loop.py``'s tolerance (rtol 1e-5), rank 0 alone
  writing the records and checkpoints, and a world-2 resume equal to the
  uninterrupted world-2 run.
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

from percivaltts_tpu.data import device_corpus as jdc
from percivaltts_tpu.data.dataset import Dataset as JaxDataset
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.parallel import make_mesh as jax_make_mesh
from percivaltts_tpu.parallel import replicate_state as jax_replicate
from percivaltts_tpu.parallel import shard_batch as jax_shard_batch
from percivaltts_tpu.parallel.distributed import _local_rows as jax_local_rows
from percivaltts_tpu.parallel.mesh import shard_stacked_batch as jax_shard_stacked
from percivaltts_tpu.training import Trainer as JaxTrainer
from percivaltts_tpu.training import loop as jax_loop
from percivaltts_tpu.training import lse as jax_lse
from percivaltts_tpu.training.state import make_gan_state as jax_make_gan_state
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.parallel import distributed, make_mesh
from percivaltts_tpu_torch.parallel.mesh import Mesh, shard_batch, shard_stacked_batch
from percivaltts_tpu_torch.training.losses import masked_mse, stream_weight_vector
from percivaltts_tpu_torch.training.lse import lse_step
from percivaltts_tpu_torch.training.state import make_gan_state
from percivaltts_tpu_torch.training.wgan import make_wgan_step
from test_torch_loop import IN_STATS, OUT_STATS, _corpus, _records, _shared_cfgs
from test_torch_loop import _state_dicts_equal
from test_torch_training import NOISE, WGAN_OPTIONS, _batch, _cfg, _compare_update
from test_torch_training import _jax_wgan_step

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B = 4  # the global batch of the steps (test_torch_training's _batch)


def _port(cfg):
    return Configuration.from_dict(cfg.to_dict())


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _fc_cfg():
    cfg = _cfg()
    return cfg.replace(model=dataclasses.replace(cfg.model, generator="fc", num_layers=2),
                       train=dataclasses.replace(cfg.train, trainer="lse"))


def _dropout_cfg():
    """The FC generator with dropout and every WGAN-GP step option."""
    cfg = _cfg(**WGAN_OPTIONS)
    return cfg.replace(model=dataclasses.replace(cfg.model, generator="fc", num_layers=2,
                                                 dropout_rate=0.3))


def _jit_init(cfg, seed):
    return jax.jit(lambda: jax_make_gan_state(cfg, cfg.data.label_dim, seed=seed))()


def _shard(arr, mesh, r):
    """The data of ``arr``'s shard on the mesh's ``r``-th device."""
    dev = mesh.devices.flat[r]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


def _port_state(cfg, sd):
    """A port state (CPU) holding the state dict a worker wrote."""
    state = make_gan_state(_port(cfg), cfg.data.label_dim, seed=1, device="cpu")
    state.load_state_dict(sd)
    return state


# --- the module's runs: two port ranks in a gloo group, JAX in this process ----


def _inputs(root):
    """Every case's inputs, and the JAX objects the references start from."""
    rng = np.random.default_rng(21)
    L, F = 13, 27
    fc = _fc_cfg()
    jfc = _jit_init(fc, seed=6)
    zero = _batch(rng, L, F)
    zero["mask"][B // 2:] = 0.0  # the padding rows Dataset.batches adds: rank 1's half
    zero["lab"][B // 2:] = 0.0
    zero["cmp"][B // 2:] = 0.0
    wcfg = _cfg(**WGAN_OPTIONS)
    jw = _jit_init(wcfg, seed=5)
    nc = wcfg.train.n_critic
    _, _, _, *eps_keys = jax.random.split(jw.key, nc + 3)
    eps = np.stack([np.asarray(jax.random.uniform(k, (B, 1, 1))) for k in eps_keys])
    dcfg = _dropout_cfg()
    labs, cmps = _corpus(11, seed=22)
    tcfg = _shared_cfgs()[0]
    tcfg = tcfg.replace(workdir=str(root / "jax"), model=dataclasses.replace(
        tcfg.model, generator="fc", num_layers=2))
    jitted = jax.jit(jax_loop.make_gan_state, static_argnums=(0, 1, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "make_gan_state",
                   lambda cfg, label_dim, seed=None, mesh=None: jitted(cfg, label_dim, seed, mesh))
        train, valid = _corpus(24, seed=2), _corpus(7, seed=3)
        jt = JaxTrainer(tcfg, JaxDataset(*train), JaxDataset(*valid),
                        mesh=jax_make_mesh(data_parallel=WORLD), workdir=tcfg.workdir,
                        in_stats=JaxNormStats(**IN_STATS), out_stats=JaxNormStats(**OUT_STATS))
    cases = {
        "lse": {"cfg": fc.to_dict(), "gen": _tree(jfc.gen.params),
                "batch": _batch(rng, L, F), "zero_batch": zero},
        "wgan": {"cfg": wcfg.to_dict(), "gen": _tree(jw.gen.params),
                 "critic": _tree(jw.critic.params), "critic_batches": _batch(rng, L, F, (nc,)),
                 "gen_batch": _batch(rng, L, F), "eps": eps},
        "dropout": {"cfg": dcfg.to_dict(), "seed": 4,
                    "critic_batches": _batch(rng, L, F, (dcfg.train.n_critic,)),
                    "gen_batch": _batch(rng, L, F)},
        "corpus": {"cfg": fc.to_dict(), "gen": _tree(jfc.gen.params), "labs": labs,
                   "cmps": cmps, "bound": 64, "batch_size": B, "seed": 3},
        "trainer": {"cfg": tcfg.to_dict(), "gen": _tree(jt.state.gen.params), "train": train,
                    "valid": valid, "in_stats": IN_STATS, "out_stats": OUT_STATS},
    }
    return cases, {"fc": (fc, jfc), "wgan": (wcfg, jw), "trainer": jt}


def _jax_references(cases, objs):
    mesh = jax_make_mesh(data_parallel=WORLD)
    fc, jfc = objs["fc"]
    lse = jax.jit(jax_lse.lse_step)
    out = {}
    for name, key in (("lse", "batch"), ("lse_zero", "zero_batch")):
        out[name] = lse(jax_replicate(jfc, mesh), jax_shard_batch(cases["lse"][key], mesh))
    wcfg, jw = objs["wgan"]
    w = cases["wgan"]
    out["wgan"] = _jax_wgan_step(wcfg)(jax_replicate(jw, mesh),
                                       jax_shard_stacked(w["critic_batches"], mesh),
                                       jax_shard_batch(w["gen_batch"], mesh))
    c = cases["corpus"]
    corpora = {}
    for sharded in (False, True):
        jc = jdc.DeviceCorpus(JaxDataset(c["labs"], c["cmps"]), bound=c["bound"], mesh=mesh,
                              shard_corpus=sharded)
        idx = list(jc.epoch_indices(c["batch_size"], 1, 0, seed=c["seed"]))
        corpora["sharded" if sharded else "replicated"] = (jc, idx)
    jc, idx = corpora["sharded"]
    step = jax.jit(jdc.make_device_lse_step(jax_lse.lse_step, sharded_mesh=mesh))
    out["corpus_step"] = step(jax_replicate(jfc, mesh), jc.data, jc.shard_indices(idx[0]))
    out["corpora"] = corpora
    jt = objs["trainer"]
    out["trainer_hist"] = jt.train(epochs=2)
    jt.close()
    out["mesh"] = mesh
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs, the JAX references and JAX objects, each rank's results)."""
    root = tmp_path_factory.mktemp("parallel")
    cases, objs = _inputs(root)
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **torch_threads.ENV)  # each rank at this worker's share of the cores
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               str(root / "inputs.pkl"), str(root)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        ref = _jax_references(cases, objs)
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


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A gloo group of one in this process, left at the end of the module."""
    path = tmp_path_factory.mktemp("group1") / "group"
    distributed.initialize(f"file://{path}", 1, 0, "gloo")
    yield make_mesh(devices=["cpu"])
    dist.destroy_process_group()


# --- (a) row slicing ---------------------------------------------------------


def test_make_mesh_shapes_and_refusals(group1, runs):
    assert group1.shape == {"data": 1, "model": 1} and group1.rank == 0
    assert make_mesh(data_parallel=1, devices=["cpu"]).shape == group1.shape
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(data_parallel=16)
    with pytest.raises(ValueError) as err:
        make_mesh(data_parallel=2)
    assert str(err.value) == str(jax_err.value).replace("16", "2").replace("8", "1")
    refusals = [r["mesh"] for r in runs[2]]
    assert refusals[0] == refusals[1]
    assert refusals[0]["too_many"] == "mesh 3x1 needs 3 devices, have 2"
    assert "spans every rank" in refusals[0]["subset"]
    assert "model_parallel=2" in refusals[0]["model"]


@pytest.mark.parametrize("n", [2, 4])
def test_rows_of_each_rank_equal_the_jax_shards(n):
    rng = np.random.default_rng(n)
    batch = _batch(rng, 13, 27)
    batch["lab"] = np.concatenate([batch["lab"]] * 2)  # 8 rows
    batch["cmp"] = np.concatenate([batch["cmp"]] * 2)
    batch["mask"] = np.concatenate([batch["mask"]] * 2)
    batch["step"] = np.int32(7)
    stacked = {k: np.stack([v, v[::-1]]) for k, v in batch.items() if k != "step"}
    jmesh = jax_make_mesh(data_parallel=n)
    jb, js = jax_shard_batch(batch, jmesh), jax_shard_stacked(stacked, jmesh)
    for r in range(n):
        mesh = Mesh(rank=r, size=n)
        got, got_stacked = shard_batch(batch, mesh), shard_stacked_batch(stacked, mesh)
        for k in ("lab", "cmp", "mask"):
            np.testing.assert_array_equal(got[k].numpy(), _shard(jb[k], jmesh, r))
            np.testing.assert_array_equal(got_stacked[k].numpy(), _shard(js[k], jmesh, r))
        assert got["step"].item() == 7 and got["lab"].shape[0] == 8 // n
    one = jax_local_rows(8, jmesh)  # one JAX process holds every row
    assert Mesh().rows(8) == one == slice(0, 8)
    with pytest.raises(ValueError, match="split evenly"):
        Mesh(rank=0, size=3).rows(8)


# --- (b) world size 1 changes nothing ----------------------------------------


def _dropout_steps(case, mesh):
    """``torch_parallel_worker._dropout`` on the whole batches, in this
    process: (metrics, state)."""
    cfg = _port(_dropout_cfg())
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    state = make_gan_state(cfg, L, seed=case["seed"], device="cpu", mesh=mesh)
    dim_w = stream_weight_vector(cfg.vocoder.streams, cfg.train.stream_weights, F)
    as_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    state, wm = make_wgan_step(cfg.train, dim_w, mesh=mesh)(
        state, as_t(case["critic_batches"]), as_t(case["gen_batch"]))
    state, lm = lse_step(state, as_t(case["gen_batch"]), dim_weights=dim_w,
                         boundary_weight=cfg.train.boundary_weight, mesh=mesh)
    return {**wm, **{"lse_" + k: v for k, v in lm.items()}}, state


def test_world_size_1_steps_equal_the_meshless_steps(group1, runs):
    """Bit for bit, metrics and parameters (the collectives of a group of
    one move nothing; the draws and the denominators are the same)."""
    case = runs[0]["dropout"]
    (m0, s0), (m1, s1) = _dropout_steps(case, None), _dropout_steps(case, group1)
    for k in m0:
        np.testing.assert_array_equal(m0[k].numpy(), m1[k].numpy(), err_msg=k)
    for part in ("gen", "critic"):
        a, b = s0.state_dict()[part], s1.state_dict()[part]
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=f"{part}.{k}")


def test_world_size_2_dropout_steps_equal_the_meshless_steps(runs):
    """The ranks' dropout masks and ε are the world-size-1 draws' rows. As
    in tests/test_torch_training.py, the adversarial metrics are compared
    with the critic's score bias added back (its true gradient is 0, and
    Adam turns the rounding residue into a step of up to lr)."""
    cases, _, ranks, _ = runs
    _ranks_equal(ranks, "dropout")
    want, state = _dropout_steps(cases["dropout"], None)
    got = _port_state(_dropout_cfg(), ranks[0]["dropout"]["state"])
    bias = got.critic.score.bias.item(), state.critic.score.bias.item()
    for k, v in want.items():
        shift = bias if k in ("loss", "gen_adv") else (0.0, 0.0)
        np.testing.assert_allclose(ranks[0]["dropout"]["metrics"][k] + shift[0],
                                   v.item() + shift[1], rtol=1e-5, err_msg=k)
    for module, opt, ref in ((got.gen, got.gen_opt, state.gen),
                             (got.critic, got.critic_opt, state.critic)):
        for p, q in zip(module.parameters(), ref.parameters()):
            g = opt.state[p]["exp_avg"].abs()
            sure = (g >= max(1e-4 * g.max().item(), NOISE)).numpy()
            np.testing.assert_allclose(p.detach().numpy()[sure], q.detach().numpy()[sure],
                                       atol=1e-6)


# --- (c), (d) world size 2 against JAX's 2-device mesh ---------------------------


def _ranks_equal(ranks, case):
    _state_dicts_equal(ranks[0][case]["state"], ranks[1][case]["state"])
    assert ranks[0][case]["metrics"] == ranks[1][case]["metrics"]


@pytest.mark.parametrize("case", ["lse", "lse_zero"])
def test_world_size_2_lse_step_matches_the_jax_mesh(runs, case):
    cases, ref, ranks, _ = runs
    _ranks_equal(ranks, case)
    fc = _fc_cfg()
    jnew, jm = ref[case]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][case]["metrics"][k], float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    state = _port_state(fc, ranks[0][case]["state"])
    _compare_update(state.gen, state.gen_opt, jnew.gen, fc.train.adam_b1)


def test_a_per_rank_denominator_would_miss(runs):
    """Rank 1's rows are all padding: the mean of the two ranks' own masked
    MSEs (what a per-rank denominator gives) is half the global loss."""
    cases, ref, ranks, _ = runs
    fc = _fc_cfg()
    batch = {k: torch.from_numpy(v) for k, v in cases["lse"]["zero_batch"].items()}
    gen = make_gan_state(_port(fc), fc.data.label_dim, device="cpu").gen
    weights.load_flax_params(gen, cases["lse"]["gen"])
    with torch.no_grad():
        pred = gen(batch["lab"])
    halves = [masked_mse(pred[s], batch["cmp"][s], batch["mask"][s])
              for s in (slice(0, B // 2), slice(B // 2, B))]
    assert halves[1].item() == 0.0
    local = (halves[0] + halves[1]).item() / 2
    want = float(ref["lse_zero"][1]["loss"])
    assert masked_mse(pred, batch["cmp"], batch["mask"]).item() == pytest.approx(want, rel=1e-4)
    assert abs(local - want) > 1e-4 * abs(want)
    np.testing.assert_allclose(ranks[1]["lse_zero"]["metrics"]["loss"], want, rtol=1e-4)


def test_world_size_2_wgan_step_matches_the_jax_mesh(runs):
    """The fused critic pass, the penalty on every second update, boundary
    frame weights and stream weights; the adversarial metrics compared
    with the score bias added back, as in tests/test_torch_training.py."""
    cases, ref, ranks, _ = runs
    _ranks_equal(ranks, "wgan")
    wcfg = _cfg(**WGAN_OPTIONS)
    jnew, jm = ref["wgan"]
    state = _port_state(wcfg, ranks[0]["wgan"]["state"])
    m = ranks[0]["wgan"]["metrics"]
    assert set(m) == set(jm)
    bias = state.critic.score.bias.item(), float(jnew.critic.params["params"]["score"]["bias"][0])
    for k in m:
        shift = bias if k in ("loss", "gen_adv") else (0.0, 0.0)
        np.testing.assert_allclose(m[k] + shift[0], float(jm[k]) + shift[1], rtol=1e-4,
                                   err_msg=k)
    _compare_update(state.critic, state.critic_opt, jnew.critic, wcfg.train.adam_b1)
    _compare_update(state.gen, state.gen_opt, jnew.gen, wcfg.train.adam_b1)


# --- (e) the device corpus ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_device_corpus_blocks_and_indices_equal_the_jax_shards(runs, layout):
    cases, ref, ranks, _ = runs
    mesh = ref["mesh"]
    jc, jidx = ref["corpora"][layout]
    for r, rank in enumerate(ranks):
        got = rank["corpus"][layout]
        for k in ("lab", "cmp", "mask"):
            want = _shard(jc.data[k], mesh, r) if layout == "sharded" else np.asarray(jc.data[k])
            np.testing.assert_array_equal(got["data"][k], want, err_msg=k)
        assert len(got["idx"]) == len(jidx)
        for i, j, loc in zip(got["idx"], jidx, got["local"]):
            np.testing.assert_array_equal(i, j)
            np.testing.assert_array_equal(loc, _shard(jc.shard_indices(j), mesh, r))
    if layout == "sharded":  # 11 utterances padded cyclically to 12, 6 a rank
        assert ranks[0]["corpus"][layout]["data"]["lab"].shape[0] == 6


def test_sharded_corpus_step_matches_the_jax_step(runs):
    cases, ref, ranks, _ = runs
    _ranks_equal([r["corpus"] for r in ranks], "step")
    fc = _fc_cfg()
    jnew, jm = ref["corpus_step"]
    got = ranks[0]["corpus"]["step"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)
    state = _port_state(fc, got["state"])
    _compare_update(state.gen, state.gen_opt, jnew.gen, fc.train.adam_b1)


# --- (f) the Trainer -------------------------------------------------------------


def test_trainer_epochs_match_the_jax_mesh_trainer(runs):
    """Each epoch's mean loss and gradient norm and the validation MSE,
    rtol 1e-5 (tests/test_torch_loop.py's tolerance), on both ranks."""
    cases, ref, ranks, _ = runs
    jhist = ref["trainer_hist"]
    for rank in ranks:
        phist = rank["trainer"]["hist"]
        assert [r["steps"] for r in phist["train"]] == [r["steps"] for r in jhist["train"]]
        pairs = [(p[k], j[k]) for j, p in zip(jhist["train"], phist["train"])
                 for k in ("loss", "grad_norm")] + list(zip(phist["valid"], jhist["valid"]))
        worst = max(abs(got - want) / abs(want) for got, want in pairs)
        print(f"world-2 LSE epochs, port vs JAX mesh: max relative difference {worst:.3g}")
        assert worst <= 1e-5
    _state_dicts_equal(ranks[0]["trainer"]["state"], ranks[1]["trainer"]["state"])


def test_trainer_rank_0_alone_writes_the_records(runs):
    cases, ref, ranks, root = runs
    whole = root / "trainer" / "whole"
    assert [len(_records(whole, kind)) for kind in ("system", "sanity", "epoch")] == [1, 1, 2]
    assert os.path.exists(whole / "config.json")
    assert len(os.listdir(whole / "traces")) == 1
    on_disk = sorted(int(d) for d in os.listdir(whole / "checkpoints"))
    assert on_disk == ranks[0]["trainer"]["steps"][0] == ranks[1]["trainer"]["steps"][0] \
        == sorted(int(d) for d in os.listdir(root / "jax" / "checkpoints") if d.isdigit())


def test_world_size_2_resume_equals_the_uninterrupted_run(runs):
    cases, ref, ranks, _ = runs
    for rank in ranks:
        t = rank["trainer"]
        assert t["resumed"]
        assert t["resumed_hist"]["train"][0]["loss"] == t["hist"]["train"][1]["loss"]
        assert t["resumed_hist"]["valid"] == t["hist"]["valid"][1:]
        _state_dicts_equal(t["resumed_state"], t["state"])
