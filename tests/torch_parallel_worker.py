"""One rank of the port's data-parallel runs that ``tests/test_torch_parallel.py``
holds against the JAX package's 2-device mesh.

Usage: python torch_parallel_worker.py <rank> <world_size> <inputs.pkl> <out_dir>

Joins a gloo process group of ``world_size`` ranks on the CPU through a
file under ``out_dir``, reads the cases' inputs (configs, flax weights as
numpy trees, batches, corpora) from ``inputs.pkl``, runs each case on this
rank's rows and writes what it computed to ``<out_dir>/rank<rank>.pt``:

* ``mesh``: the messages of ``make_mesh``'s three refusals;
* ``lse``, ``lse_zero``: an LSE step of the FC generator (the second on a
  batch whose second half has zero masks), metrics and the state dict;
* ``wgan``: a WGAN-GP step of the tiny CNN+BiLSTM generator with ε given;
* ``dropout``: a WGAN-GP step, then an LSE step, of the FC generator with
  dropout, each drawing its own ε and masks from the state's generator;
* ``corpus``: the replicated and the sharded device corpus (this rank's
  block, one epoch's global and local index arrays) and one LSE step
  gathered from the sharded one;
* ``trainer``: 2 LSE epochs of the ``Trainer`` (records, validation,
  state), and the same 2 epochs as 1, a fresh ``Trainer``, ``resume()``
  and 1 more.

Imports nothing of JAX or of the JAX package.
"""

import functools
import os
import pickle
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from percivaltts_tpu_torch import weights  # noqa: E402
from percivaltts_tpu_torch.config import Configuration  # noqa: E402
from percivaltts_tpu_torch.data import device_corpus as dc  # noqa: E402
from percivaltts_tpu_torch.data.dataset import Dataset  # noqa: E402
from percivaltts_tpu_torch.data.normalize import NormStats  # noqa: E402
from percivaltts_tpu_torch.parallel import distributed, make_mesh  # noqa: E402
from percivaltts_tpu_torch.parallel.mesh import shard_batch, shard_stacked_batch  # noqa: E402
from percivaltts_tpu_torch.training import Trainer  # noqa: E402
from percivaltts_tpu_torch.training.losses import stream_weight_vector  # noqa: E402
from percivaltts_tpu_torch.training.lse import lse_step  # noqa: E402
from percivaltts_tpu_torch.training.state import make_gan_state  # noqa: E402
from percivaltts_tpu_torch.training.wgan import make_wgan_step  # noqa: E402


def _state(case, mesh):
    cfg = Configuration.from_dict(case["cfg"])
    state = make_gan_state(cfg, cfg.data.label_dim, seed=1, device="cpu", mesh=mesh)
    weights.load_flax_params(state.gen, case["gen"])
    if "critic" in case:
        weights.load_flax_params(state.critic, case["critic"])
    return cfg, state


def _result(state, metrics):
    return {"state": state.state_dict(), "metrics": {k: v.item() for k, v in metrics.items()}}


def _refusals() -> dict:
    out = {}
    for name, kw in (("too_many", dict(data_parallel=3)), ("subset", dict(data_parallel=1)),
                     ("model", dict(model_parallel=2))):
        try:
            make_mesh(devices=["cpu"] * 2, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _lse(case, batch, mesh):
    _, state = _state(case, mesh)
    state, m = lse_step(state, shard_batch(batch, mesh), mesh=mesh)
    return _result(state, m)


def _wgan(case, mesh):
    cfg, state = _state(case, mesh)
    dim_w = stream_weight_vector(cfg.vocoder.streams, cfg.train.stream_weights,
                                 cfg.vocoder.feature_size)
    step = make_wgan_step(cfg.train, dim_w, mesh=mesh)
    state, m = step(state, shard_stacked_batch(case["critic_batches"], mesh),
                    shard_batch(case["gen_batch"], mesh), eps=torch.from_numpy(case["eps"]))
    return _result(state, m)


def _dropout(case, mesh):
    cfg = Configuration.from_dict(case["cfg"])
    state = make_gan_state(cfg, cfg.data.label_dim, seed=case["seed"], device="cpu", mesh=mesh)
    dim_w = stream_weight_vector(cfg.vocoder.streams, cfg.train.stream_weights,
                                 cfg.vocoder.feature_size)
    state, wm = make_wgan_step(cfg.train, dim_w, mesh=mesh)(
        state, shard_stacked_batch(case["critic_batches"], mesh),
        shard_batch(case["gen_batch"], mesh))
    state, lm = lse_step(state, shard_batch(case["gen_batch"], mesh), dim_weights=dim_w,
                         boundary_weight=cfg.train.boundary_weight, mesh=mesh)
    return _result(state, {**wm, **{"lse_" + k: v for k, v in lm.items()}})


def _corpus(case, mesh):
    ds = Dataset(case["labs"], case["cmps"])
    out = {}
    for sharded in (False, True):
        corpus = dc.DeviceCorpus(ds, bound=case["bound"], mesh=mesh, shard_corpus=sharded,
                                 device="cpu")
        idx = list(corpus.epoch_indices(case["batch_size"], 1, 0, seed=case["seed"]))
        out["sharded" if sharded else "replicated"] = {
            "data": {k: v.numpy() for k, v in corpus.data.items()},
            "idx": idx,
            "local": [corpus.shard_indices(i).numpy() for i in idx],
        }
    _, state = _state(case, mesh)  # one step gathered from the sharded corpus
    step = dc.make_device_lse_step(functools.partial(lse_step, mesh=mesh))
    state, m = step(state, corpus.data, corpus.shard_indices(idx[0]))
    out["step"] = _result(state, m)
    return out


def _trainer(case, mesh, root):
    cfg = Configuration.from_dict(case["cfg"])
    train, valid = Dataset(*case["train"]), Dataset(*case["valid"])
    stats = dict(in_stats=NormStats(**case["in_stats"]), out_stats=NormStats(**case["out_stats"]))

    def trainer(workdir):
        return Trainer(cfg, train, valid, mesh=mesh, workdir=os.path.join(root, workdir),
                       device="cpu", **stats)

    whole = trainer("whole")
    weights.load_flax_params(whole.state.gen, case["gen"])
    whole.state.ema = {n: p.detach().clone() for n, p in whole.state.gen.named_parameters()}
    hist = whole.train(epochs=2)
    whole.close()

    first = trainer("split")
    weights.load_flax_params(first.state.gen, case["gen"])
    first.state.ema = {n: p.detach().clone() for n, p in first.state.gen.named_parameters()}
    first.train(epochs=1)
    first.close()
    second = trainer("split")
    resumed = second.resume()
    hist2 = second.train(epochs=2)
    second.close()
    return {"hist": hist, "state": whole.state.state_dict(), "resumed": resumed,
            "resumed_hist": hist2, "resumed_state": second.state.state_dict(),
            "steps": (whole.ckpt.all_steps(), second.ckpt.all_steps())}


def main():
    rank, world, inputs, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    distributed.initialize(f"file://{os.path.join(out_dir, 'group')}", world, rank, "gloo")
    mesh = make_mesh(devices=["cpu"] * world)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    out = {
        "mesh": _refusals(),
        "lse": _lse(cases["lse"], cases["lse"]["batch"], mesh),
        "lse_zero": _lse(cases["lse"], cases["lse"]["zero_batch"], mesh),
        "wgan": _wgan(cases["wgan"], mesh),
        "dropout": _dropout(cases["dropout"], mesh),
        "corpus": _corpus(cases["corpus"], mesh),
        "trainer": _trainer(cases["trainer"], mesh, os.path.join(out_dir, "trainer")),
    }
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
