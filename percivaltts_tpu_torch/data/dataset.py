"""Data loading + static-shape bucketed batching (the port's copy of
``percivaltts_tpu/data/dataset.py``, which is numpy only).

Reference parity: ``percivaltts/data.py`` — file-id-list train/valid/test
splits, shuffled batches of variable-length utterances padded with masks,
plus sanity-cost helpers (RMSE of the always-predict-zero model).

Sequences are bucketed to a small static set of length bounds
(``bucket_bounds``) and padded to the bucket bound; masks are threaded
through every loss and metric. The JAX package assembles each batch in its
native C++ data plane when that is built; this copy assembles it in numpy,
as that module's own fallback does (``_assemble``): the same batches, bit
for bit, from the same random draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def split_fileids(
    fileids: Sequence[str], num_valid: int, num_test: int
) -> Tuple[List[str], List[str], List[str]]:
    """Positional train/valid/test split of the file-id list, mirroring the
    reference's list-slicing convention: the last ``num_test`` ids are test,
    the ``num_valid`` before those are validation, the rest train."""
    ids = list(fileids)
    if num_valid + num_test >= len(ids):
        raise ValueError(
            f"split ({num_valid} valid + {num_test} test) leaves no training "
            f"data out of {len(ids)} files"
        )
    ntr = len(ids) - num_valid - num_test
    return ids[:ntr], ids[ntr : ntr + num_valid], ids[ntr + num_valid :]


def cost_0pred_rmse(arrays: Sequence[np.ndarray]) -> float:
    """RMSE of the always-predict-zero model over normalized targets — the
    reference's sanity scale for training losses (data.py)."""
    sq = 0.0
    n = 0
    for a in arrays:
        sq += float(np.sum(np.square(a, dtype=np.float64)))
        n += a.size
    return float(np.sqrt(sq / max(n, 1)))


def _assemble(
    arrays: Sequence[np.ndarray],
    offsets: Sequence[int],
    lengths: Sequence[int],
    bound: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded batch (B, bound, dim) + mask (B, bound) from per-utterance
    float32 (frames, dim) matrices: row j holds ``lengths[j]`` frames from
    ``offsets[j]`` and zeros after (the numpy path of the JAX package's
    ``native.assemble_batch``)."""
    out = np.zeros((len(arrays), bound, arrays[0].shape[1]), dtype=np.float32)
    mask = np.zeros((len(arrays), bound), dtype=np.float32)
    for j, a in enumerate(arrays):
        n = lengths[j]
        out[j, :n] = a[offsets[j] : offsets[j] + n]
        mask[j, :n] = 1.0
    return out, mask


@dataclass
class Dataset:
    """An in-memory utterance corpus with bucketed, masked batching.

    ``labs[i]``: (frames_i, label_dim) float32 input features
    ``cmps[i]``: (frames_i, feat_dim) float32 target features
    """

    labs: List[np.ndarray]
    cmps: List[np.ndarray]
    ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        if len(self.labs) != len(self.cmps):
            raise ValueError("labs/cmps length mismatch")
        for i, (l, c) in enumerate(zip(self.labs, self.cmps)):
            n = min(l.shape[0], c.shape[0])
            # label and acoustic frame counts can differ by a frame or two at
            # utterance edges (alignment rounding); trim to the overlap, as
            # the reference does.
            self.labs[i] = np.asarray(l[:n], dtype=np.float32)
            self.cmps[i] = np.asarray(c[:n], dtype=np.float32)
        if not self.ids:
            self.ids = [f"utt{i:04d}" for i in range(len(self.labs))]

    def __len__(self) -> int:
        return len(self.labs)

    @property
    def label_dim(self) -> int:
        return self.labs[0].shape[1]

    @property
    def feat_dim(self) -> int:
        return self.cmps[0].shape[1]

    @property
    def num_frames(self) -> int:
        return int(sum(l.shape[0] for l in self.labs))

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Per-process shard for multi-host training: process i keeps
        utterances i, i+num_shards, …"""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range({num_shards})")
        sel = list(range(index, len(self), num_shards))
        return Dataset(
            labs=[self.labs[i] for i in sel],
            cmps=[self.cmps[i] for i in sel],
            ids=[self.ids[i] for i in sel],
        )

    def subset(self, ids: Sequence[str]) -> "Dataset":
        index = {u: i for i, u in enumerate(self.ids)}
        sel = [index[u] for u in ids]
        return Dataset(
            labs=[self.labs[i] for i in sel],
            cmps=[self.cmps[i] for i in sel],
            ids=list(ids),
        )

    # ------------------------------------------------------------------ #
    # batching
    # ------------------------------------------------------------------ #

    def _bucket_of(self, n: int, bounds: Sequence[int]) -> int:
        for b in bounds:
            if n <= b:
                return b
        return bounds[-1]  # longer utterances get cropped to the last bound

    def batches(
        self,
        batch_size: int,
        bucket_bounds: Sequence[int] = (256, 512, 768, 1024),
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        crop_to_max: bool = True,
        epoch: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict batches ``{"lab", "cmp", "mask", "lengths"}`` with
        static shapes ``(batch_size, bound, dim)`` per bucket.

        When ``crop_to_max`` is set, utterances longer than the largest bound
        are randomly cropped (a fresh crop each epoch) rather than dropped —
        matching the reference's length-cropping behavior.
        """
        bounds = sorted(bucket_bounds)
        rng = np.random.default_rng(np.uint32(seed) + np.uint32(epoch))
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)

        buckets: Dict[int, List[int]] = {b: [] for b in bounds}
        for i in order:
            n = self.labs[i].shape[0]
            if n > bounds[-1] and not crop_to_max:
                continue
            buckets[self._bucket_of(n, bounds)].append(int(i))

        # interleave buckets so compilation variants appear early and the
        # batch order stays shuffled across buckets
        pending: List[Tuple[int, List[int], int]] = []
        for b in bounds:
            idxs = buckets[b]
            for k in range(0, len(idxs), batch_size):
                chunk = idxs[k : k + batch_size]
                nreal = len(chunk)
                if nreal < batch_size:
                    if drop_remainder:
                        continue
                    # pad the batch by CYCLING utterances up to batch_size
                    # (a bucket smaller than the deficit must still fill the
                    # static batch shape — sharded meshes need divisible row
                    # counts); the repeated rows get zero masks/lengths below
                    # so they cannot bias masked losses or frame-weighted
                    # validation
                    pad = [
                        idxs[j % len(idxs)] for j in range(batch_size - nreal)
                    ]
                    chunk = chunk + pad
                pending.append((b, chunk, nreal))
        if shuffle:
            rng.shuffle(pending)  # type: ignore[arg-type]

        for bound, chunk, nreal in pending:
            offsets, lengths = [], []
            for j, i in enumerate(chunk):
                if j >= nreal:
                    offsets.append(0)
                    lengths.append(0)
                    continue
                n = self.labs[i].shape[0]
                if n > bound:
                    offsets.append(int(rng.integers(0, n - bound + 1)))
                    lengths.append(bound)
                else:
                    offsets.append(0)
                    lengths.append(n)
            # the same offsets crop lab and cmp consistently
            lab, mask = _assemble([self.labs[i] for i in chunk], offsets, lengths, bound)
            cmp_, _ = _assemble([self.cmps[i] for i in chunk], offsets, lengths, bound)
            yield {
                "lab": lab,
                "cmp": cmp_,
                "mask": mask,
                "lengths": np.asarray(lengths, np.int32),
            }

