"""Data parallelism over a process group (counterpart of
``percivaltts_tpu/parallel/mesh.py``).

The JAX package shards each batch over the ``data`` axis of a device mesh
and lets XLA insert the gradient all-reduces (``psum``) inside the jitted
step, so every loss term is computed over the global batch. Here one
process drives one device, as is PyTorch's idiom: the ranks of a
``torch.distributed`` process group (NCCL on the card, gloo on the CPU)
each hold the whole replicated state and compute on their own rows of
every global batch. The steps call the two collectives that stand where
XLA's ``psum``s stand: :func:`global_sum` for a batch-level quantity (a
loss denominator), and :func:`all_reduce_grads` once per optimizer update,
between ``backward()`` and ``opt.step()``. Means over the batch become
local means divided by the rank count, and random draws are made at the
global shape and cut to the rank's rows, so a step at any world size
computes what the step at world size 1 computes.

The ``model`` axis stays 1: nothing in either package shards a model.

A JAX run is one process over a host's devices, or one process a host
(``jax.process_count() > 1``), and its sharded device corpus is laid out
differently in each (``data/device_corpus.py``). Every rank here is a
process, so the runtime cannot tell the two apart: ``Mesh.per_process``
says which of them the ranks stand for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """This rank's place in the data-parallel group: ``rank`` of ``size``
    ranks, its ``device``, and the process group (``None``: the default
    group). Row slicing needs no process group; the collectives do.

    ``per_process``: the ranks stand for the processes of a multi-process
    JAX run, each with its own data, and not for the devices of one JAX
    process. It is the counterpart of the JAX runtime's process count
    (``jax.process_count() > 1``) and nothing else."""

    rank: int = 0
    size: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    per_process: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size, "model": 1}

    def rows(self, n: int) -> slice:
        """This rank's rows ``[r·n/size, (r+1)·n/size)`` of ``n`` global rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def all_gather_int(self, value: int) -> np.ndarray:
        """Every rank's ``value``, by rank, in one all-gather: a tensor on
        the mesh's device under NCCL, on the host under gloo."""
        on = self.device if dist.get_backend(self.group) == "nccl" else torch.device("cpu")
        t = torch.tensor([value], dtype=torch.int64, device=on)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.cat(out).cpu().numpy()

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (a picklable Python value)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]


def _rank_device(device, local_rank: int) -> torch.device:
    """``cuda`` without an index is the card of this rank's local rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def make_mesh(
    data_parallel: int = 0,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
    per_process: bool = False,
) -> Mesh:
    """The data-parallel mesh over the initialized process group
    (``distributed.initialize``). ``data_parallel=0`` means every rank; any
    other value must equal the world size (a mesh over a subset of the
    ranks would leave the others idle). ``devices``: one device per rank,
    indexed by rank (``"cuda"`` without an index is the rank's local card);
    by default the local card, or the CPU where there is none.
    ``per_process``: the ranks stand for a multi-process JAX run's
    processes (``Mesh.per_process``); by default for one process's
    devices."""
    if model_parallel != 1:
        raise ValueError(f"model_parallel={model_parallel}: only a data axis is supported")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call percivaltts_tpu_torch.parallel.distributed.initialize() "
            "first (under torch.distributed.run it reads the launcher's environment)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data_parallel <= 0:
        data_parallel = world
    n = data_parallel * model_parallel
    if n > world:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} needs {n} devices, have {world}")
    if n != world:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} over {world} ranks: a mesh spans every "
            "rank (data_parallel 0 or the world size)")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if devices is None:
        device = torch.device("cuda", local_rank) if torch.cuda.is_available() else "cpu"
    else:
        if len(devices) < world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = devices[rank]
    return Mesh(rank=rank, size=world, device=_rank_device(device, local_rank),
                group=dist.group.WORLD, per_process=per_process)


def local_rows(v, mesh: Mesh, axis: int = 0):
    """This rank's rows of a numpy array or tensor along ``axis``; a 0-d
    value passes through whole."""
    if v.ndim == 0:
        return v
    index = [slice(None)] * v.ndim
    index[axis] = mesh.rows(v.shape[axis])
    return v[tuple(index)]


def _local_on_device(v, mesh: Mesh, axis: int) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(local_rows(np.asarray(v), mesh, axis)))
        return v.to(mesh.device)
    return local_rows(v, mesh, axis).to(mesh.device)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (numpy arrays or tensors, rows on
    the leading axis) on its device; scalars pass through whole."""
    return {k: _local_on_device(v, mesh, 0) for k, v in batch.items()}


def shard_stacked_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a stacked ``(n_critic, B, ...)`` batch: axis 1."""
    return {k: _local_on_device(v, mesh, 1) for k, v in batch.items()}


def global_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``t`` over the ranks (an all-reduce SUM, on a copy);
    ``t`` itself when ``mesh`` is None."""
    if mesh is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_reduce_grads(params, mesh: Optional[Mesh], extras: Sequence[torch.Tensor] = ()):
    """Sum the gradients of ``params`` over the ranks in one flat f32
    all-reduce, in place, and return ``extras`` (0-d tensors: a step's
    metric shares) summed in the same buffer, so a step's metrics come out
    global without a collective of their own. A parameter without a
    gradient keeps None and takes no slot: every rank runs the same graph,
    so every rank holds the same set. With ``mesh`` None, nothing moves."""
    extras = [e.detach() for e in extras]
    if mesh is None:
        return extras
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [e.reshape(1).float() for e in extras])
    dist.all_reduce(flat, group=mesh.group)
    parts = flat.split([g.numel() for g in grads] + [len(extras)])
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])
    return list(parts[-1].unbind())


def replicate_state(state, mesh: Mesh):
    """Rank 0's training state on every rank, in place: every tensor of
    ``state.state_dict()`` is broadcast from rank 0 and the dict loaded
    back, so the state decides what it holds (parameters, buffers,
    optimizer moments, EMA, generator state). Returns ``state``."""
    sd = state.state_dict()
    broadcast_tensors(_tensors(sd), mesh)
    state.load_state_dict(sd)
    return state


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def broadcast_tensors(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place: one
    broadcast for each dtype among them. Tensors on another device (Adam's
    step counts on the host, the generator state) travel through the
    mesh's device."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group])
        dist.broadcast(flat, src=0, group=mesh.group)
        off = 0
        for t in group:
            n = t.numel()
            t.detach().copy_(flat[off:off + n].view_as(t))
            off += n
