"""The training corpus resident on the device; batches gathered there
(counterpart of ``percivaltts_tpu/data/device_corpus.py``).

A TTS acoustic corpus is small beside the card's memory (an hour of 16 kHz
speech at 525 feature dims is ~1.5 GB in f32, half that in bf16), so the
whole training set is padded to the largest bucket bound and copied to the
card once. Every step then ships one small int32 index array, and the
batch is gathered on the device. Epoch shuffling stays on the host: a
permutation of utterance indices, made exactly as the JAX package makes it.

Under a data-parallel mesh (``parallel/mesh.py``) every rank computes the
same global index arrays and gathers its own columns. By default each rank
holds the whole corpus. With ``shard_corpus=True`` the corpus is cut into
one block per rank (device memory scales with the rank count), and the
index arrays' columns of rank ``r`` index its block, each block shuffled
on its own as the JAX package shuffles them. The block is laid out as the
JAX package lays it out in one of its two runtimes, which the mesh names
(``Mesh.per_process``):

* one JAX process over its devices (the default): every rank reads the
  whole corpus, pads it cyclically to a multiple of the rank count, draws
  the crops over the global padded rows, and uploads block ``r`` of it;
* one JAX process a host (``jax.process_count() > 1``): ``ds`` is this
  rank's own data, normally its ``Dataset.shard(size, rank)``. The ranks'
  utterance counts are all-gathered once, and each rank pads its own rows
  cyclically to the largest count, draws the crops over those rows, and
  uploads them. ``num_utts`` is the rank's count and ``num_utts_padded``
  the largest count times the rank count.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from percivaltts_tpu_torch.data.dataset import Dataset

def to_bfloat16(a: np.ndarray) -> torch.Tensor:
    """float32 → bfloat16 on the host, bit for bit as ``ml_dtypes`` casts
    (the JAX package's corpus cast): round to nearest even, and every NaN
    the quiet NaN of its sign (torch writes 0xFFFF for any NaN)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    nan = np.isnan(a)
    if nan.any():
        bits = t.view(torch.int16).numpy()
        bits[nan] = np.where(np.signbit(a[nan]), 0xFFC0, 0x7FC0).astype(np.uint16).view(np.int16)
    return t


class DeviceCorpus:
    """All utterances padded to ``bound`` and resident on ``device``:
    ``data`` holds ``lab`` and ``cmp`` in ``dtype`` and the mask in f32,
    each ``(rows, bound, ·)``: every utterance, or with ``shard_corpus``
    this rank's block of the padded corpus."""

    def __init__(
        self,
        ds: Dataset,
        bound: int,
        dtype: str = "float32",
        mesh=None,
        crop_seed: int = 0,
        shard_corpus: bool = False,
        device="cuda",
    ):
        if shard_corpus and mesh is None:
            raise ValueError("shard_corpus=True requires a mesh")
        N = len(ds)
        self.n_shards = mesh.size if shard_corpus else 1
        if shard_corpus and mesh.per_process and mesh.size > 1:
            # every rank gathers before any raises, so none waits for a
            # rank that has left
            counts = mesh.all_gather_int(N)
            empty = [r for r, n in enumerate(counts) if n == 0]
            if empty:
                raise ValueError(f"no utterances on rank(s) {empty}: a per-process corpus "
                                 f"needs data on every rank (counts {counts.tolist()})")
            N_local = int(counts.max())
            N_pad = N_local * self.n_shards
            rows = range(N_local)
        else:
            N_pad = N_local = -(-N // self.n_shards) * self.n_shards
            rows = range(N_pad)[mesh.rows(N_pad)] if shard_corpus else range(N)
        L, F = ds.label_dim, ds.feat_dim
        # the padding rows cycle through the real utterances (real masks),
        # so no block is all padding
        rng = np.random.default_rng(crop_seed)
        # a long utterance gets one fixed random crop at upload time, drawn
        # for every padded row this process holds in order, as the JAX
        # package draws them
        offsets = [int(rng.integers(0, n - bound + 1)) if n > bound else 0
                   for n in (ds.labs[i % N].shape[0] for i in range(N_local))]
        lab = np.zeros((len(rows), bound, L), np.float32)
        cmp_ = np.zeros((len(rows), bound, F), np.float32)
        mask = np.zeros((len(rows), bound), np.float32)
        for j, i in enumerate(rows):
            x, c, off = ds.labs[i % N], ds.cmps[i % N], offsets[i]
            n = min(x.shape[0], bound)
            lab[j, :n] = x[off : off + n]
            cmp_[j, :n] = c[off : off + n]
            mask[j, :n] = 1.0
        self.device = torch.device(device)
        cast = to_bfloat16 if dtype == "bfloat16" else torch.from_numpy
        # cast on the host, then one copy each; the mask stays f32
        self.data: Dict[str, torch.Tensor] = {
            "lab": cast(lab).to(self.device), "cmp": cast(cmp_).to(self.device),
            "mask": torch.from_numpy(mask).to(self.device)}
        self.nbytes = sum(t.numel() * t.element_size() for t in self.data.values())
        self.num_utts = N
        self.num_utts_padded = N_pad
        self.bound = bound
        self.mesh = mesh
        self.shard_corpus = shard_corpus

    def epoch_indices(
        self,
        batch_size: int,
        group: int,
        epoch: int,
        seed: int = 0,
        num_steps: int = 0,
    ) -> Iterator[np.ndarray]:
        """Host-side shuffling: yield ``(group, batch_size)`` int32 index
        arrays (group = n_critic + 1 for WGAN, 1 for LSE). ``num_steps=0``
        is one pass over the corpus; otherwise exactly that many steps,
        re-shuffling as needed. Fresh permutations are appended whenever the
        corpus tail cannot fill a step, so every step is full-size.

        With a corpus sharded over ``n`` ranks the columns
        ``[r·B/n, (r+1)·B/n)`` hold indices into block ``r``, each block
        permuted on its own; unsharded, the one block is the corpus."""
        rng = np.random.default_rng(np.uint32(seed) + np.uint32(epoch))
        n = self.n_shards
        if batch_size % n != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the corpus shard count ({n})")
        b_local = batch_size // n
        local_n = self.num_utts_padded // n
        per_step = b_local * group
        nsteps = num_steps or max(local_n // per_step, 1)
        reps = -(-(nsteps * per_step) // local_n)
        perms = [np.concatenate([rng.permutation(local_n) for _ in range(reps)])
                 for _ in range(n)]
        for s in range(nsteps):
            cols = [p[s * per_step : (s + 1) * per_step].reshape(group, b_local) for p in perms]
            yield np.concatenate(cols, axis=1).astype(np.int32)

    def shard_indices(self, idx: np.ndarray) -> torch.Tensor:
        """The index array (this rank's columns under a mesh) on the
        corpus's device: one pinned host tensor, copied without blocking
        the host."""
        if self.mesh is not None:
            idx = idx[:, self.mesh.rows(idx.shape[1])]
        t = torch.from_numpy(np.ascontiguousarray(idx))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)


def gather_batch(corpus_data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """On-device gather: idx (..., B) → a batch dict with idx's leading
    shape."""
    return {
        "lab": corpus_data["lab"][idx],
        "cmp": corpus_data["cmp"][idx],
        "mask": corpus_data["mask"][idx].float(),
    }


def make_device_wgan_step(base_step, n_critic: int):
    """Wrap a WGAN step to take (state, corpus_data, idx) with idx
    (n_critic + 1, B): the critic and generator batches are gathered on the
    device."""

    def step(state, corpus_data, idx):
        batches = gather_batch(corpus_data, idx)  # leading (n_critic + 1, B)
        critic_b = {k: v[:n_critic] for k, v in batches.items()}
        gen_b = {k: v[n_critic] for k, v in batches.items()}
        return base_step(state, critic_b, gen_b)

    return step


def make_device_lse_step(base_step):
    """Wrap an LSE step to take (state, corpus_data, idx) with idx (1, B)."""

    def step(state, corpus_data, idx):
        batches = gather_batch(corpus_data, idx)
        return base_step(state, {k: v[0] for k, v in batches.items()})

    return step
