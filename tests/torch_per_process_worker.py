"""One rank of the per-process corpus runs that
``tests/test_torch_per_process_corpus.py`` holds against the JAX
package's multi-process ``DeviceCorpus``.

Usage: python torch_per_process_worker.py <rank> <world_size> <inputs.pkl> <out_dir>

Joins a gloo process group of ``world_size`` ranks on the CPU through a
file under ``out_dir`` and builds a mesh whose ranks stand for processes
(``make_mesh(per_process=True)``). Every case gives this rank only its own
``Dataset.shard(world_size, rank)`` of the corpus in ``inputs.pkl``, and
what the rank computed goes to ``<out_dir>/rank<rank>.pt``:

* ``blocks``: a ``shard_corpus=True`` device corpus in f32 and in bf16
  (its block, counts, two epochs' index arrays and this rank's columns of
  them) and the all-gathers its construction made;
* ``empty``: the error of a corpus whose rank 1 holds no utterance;
* ``trainer``: 2 LSE epochs of the ``Trainer`` from the per-process corpus
  (history, state, the corpus's counts).

Imports nothing of JAX or of the JAX package.
"""

import os
import pickle
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from percivaltts_tpu_torch import weights  # noqa: E402
from percivaltts_tpu_torch.config import Configuration  # noqa: E402
from percivaltts_tpu_torch.data.dataset import Dataset  # noqa: E402
from percivaltts_tpu_torch.data.device_corpus import DeviceCorpus  # noqa: E402
from percivaltts_tpu_torch.data.normalize import NormStats  # noqa: E402
from percivaltts_tpu_torch.parallel import distributed, make_mesh  # noqa: E402
from percivaltts_tpu_torch.training import Trainer  # noqa: E402


def _bits(t: torch.Tensor):
    """A block's values as numpy; bf16 as its 16-bit patterns."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _blocks(case, mesh):
    ds = Dataset(case["labs"], case["cmps"]).shard(mesh.size, mesh.rank)
    out = {}
    for dtype in ("float32", "bfloat16"):
        gathers, gather = [], dist.all_gather
        dist.all_gather = lambda *a, **kw: gathers.append(1) or gather(*a, **kw)
        try:
            corpus = DeviceCorpus(ds, bound=case["bound"], dtype=dtype, mesh=mesh,
                                  shard_corpus=True, device="cpu")
        finally:
            dist.all_gather = gather
        idx = [list(corpus.epoch_indices(case["batch_size"], case["group"], e,
                                         seed=case["seed"])) for e in range(2)]
        out[dtype] = {
            "data": {k: _bits(v) for k, v in corpus.data.items()},
            "num_utts": corpus.num_utts, "num_utts_padded": corpus.num_utts_padded,
            "nbytes": corpus.nbytes, "all_gathers": len(gathers), "idx": idx,
            "local": [[corpus.shard_indices(i).numpy() for i in e] for e in idx],
        }
    return out


def _empty(case, mesh):
    """Rank 0 holds one utterance and rank 1 none: every rank raises."""
    ds = Dataset(case["labs"][:1], case["cmps"][:1]).shard(mesh.size, mesh.rank)
    try:
        DeviceCorpus(ds, bound=case["bound"], mesh=mesh, shard_corpus=True, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def _trainer(case, mesh, root):
    cfg = Configuration.from_dict(case["cfg"])
    train = Dataset(*case["train"]).shard(mesh.size, mesh.rank)
    trainer = Trainer(cfg, train, Dataset(*case["valid"]), mesh=mesh,
                      workdir=os.path.join(root, "trainer"), device="cpu",
                      in_stats=NormStats(**case["in_stats"]),
                      out_stats=NormStats(**case["out_stats"]))
    weights.load_flax_params(trainer.state.gen, case["gen"])
    trainer.state.ema = {n: p.detach().clone() for n, p in trainer.state.gen.named_parameters()}
    hist = trainer.train(epochs=2)
    trainer.close()
    c = trainer.dcorpus
    return {"hist": hist, "state": trainer.state.state_dict(),
            "corpus": (c.num_utts, c.num_utts_padded, c.data["lab"].shape[0])}


def main():
    rank, world, inputs, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    distributed.initialize(f"file://{os.path.join(out_dir, 'group')}", world, rank, "gloo")
    mesh = make_mesh(devices=["cpu"] * world, per_process=True)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    out = {
        "per_process": mesh.per_process,
        "blocks": _blocks(cases["blocks"], mesh),
        "empty": _empty(cases["blocks"], mesh),
        "trainer": _trainer(cases["trainer"], mesh, out_dir),
    }
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
