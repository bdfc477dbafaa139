"""The port's copies of ``data/dataset.py`` and ``utils/prefetch.py``
against the JAX package's: the same batches bit for bit (the same random
draws, crop offsets and cycled pad rows; the port assembles them in numpy
where the JAX package may use its native data plane), the same splits and
sanity cost, and the prefetch thread's behaviour."""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import time

import numpy as np
import pytest

from percivaltts_tpu.data import dataset as jax_dataset
from percivaltts_tpu_torch.data import dataset
from percivaltts_tpu_torch.utils.prefetch import prefetch

BOUNDS = [(64,), (32, 64), (16, 48, 96)]


def _corpus(n=23, seed=0):
    """Utterances of 5–130 frames (some past every bound, so they are
    cropped), label and target frame counts off by one on a few."""
    rng = np.random.default_rng(seed)
    labs, cmps = [], []
    for i in range(n):
        frames = int(rng.integers(5, 131))
        labs.append(rng.normal(size=(frames + (i % 3 == 0), 7)).astype(np.float32))
        cmps.append(rng.normal(size=(frames, 5)).astype(np.float32))
    ids = [f"u{i:03d}" for i in range(n)]
    return (dataset.Dataset(list(labs), list(cmps), list(ids)),
            jax_dataset.Dataset(list(labs), list(cmps), list(ids)))


def _assert_same_batches(mine, theirs):
    mine, theirs = list(mine), list(theirs)
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batches_equal_the_jax_batches(bounds, shuffle, drop_remainder):
    """Three epochs, with crops (a fresh draw each epoch) and, without
    ``drop_remainder``, the cycled pad rows with zero masks and lengths."""
    mine, theirs = _corpus()
    for epoch in range(3):
        kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop_remainder, epoch=epoch)
        _assert_same_batches(mine.batches(4, bounds, **kw), theirs.batches(4, bounds, **kw))


def test_pad_rows_cycle_with_zero_masks_and_lengths():
    mine, theirs = _corpus(n=5)
    got = list(mine.batches(8, (256,), shuffle=False, drop_remainder=False))
    _assert_same_batches(got, theirs.batches(8, (256,), shuffle=False, drop_remainder=False))
    (b,) = got
    assert list(b["lengths"][5:]) == [0, 0, 0]
    assert b["mask"][5:].sum() == 0 and b["lab"][5:].sum() == 0


def test_without_crop_long_utterances_are_dropped_as_in_jax():
    mine, theirs = _corpus()
    kw = dict(shuffle=True, seed=3, crop_to_max=False, drop_remainder=False, epoch=1)
    _assert_same_batches(mine.batches(4, (32, 64), **kw), theirs.batches(4, (32, 64), **kw))


def test_shard_subset_and_properties_equal_the_jax_ones():
    mine, theirs = _corpus()
    for n, i in ((3, 0), (3, 2), (1, 0)):
        a, b = mine.shard(n, i), theirs.shard(n, i)
        assert a.ids == b.ids
        _assert_same_batches(a.batches(2, (64,), epoch=1), b.batches(2, (64,), epoch=1))
    with pytest.raises(ValueError):
        mine.shard(3, 3)
    ids = ["u007", "u002", "u019"]
    a, b = mine.subset(ids), theirs.subset(ids)
    assert a.ids == b.ids == ids
    for x, y in zip(a.labs + a.cmps, b.labs + b.cmps):
        np.testing.assert_array_equal(x, y)
    assert (mine.label_dim, mine.feat_dim, mine.num_frames, len(mine)) == (
        theirs.label_dim, theirs.feat_dim, theirs.num_frames, len(theirs))
    assert dataset.Dataset([np.zeros((3, 2))], [np.zeros((3, 1))]).ids == ["utt0000"]
    with pytest.raises(ValueError):
        dataset.Dataset([np.zeros((3, 2))], [])


def test_split_fileids_and_zero_predictor_rmse_equal_the_jax_ones():
    ids = [f"f{i}" for i in range(10)]
    for nv, nt in ((2, 3), (0, 0), (5, 4)):
        assert dataset.split_fileids(ids, nv, nt) == jax_dataset.split_fileids(ids, nv, nt)
    for mod in (dataset, jax_dataset):
        with pytest.raises(ValueError, match="leaves no training data"):
            mod.split_fileids(ids, 5, 5)
    mine, _ = _corpus()
    assert dataset.cost_0pred_rmse(mine.cmps) == jax_dataset.cost_0pred_rmse(mine.cmps)
    assert dataset.cost_0pred_rmse([]) == jax_dataset.cost_0pred_rmse([]) == 0.0


# --- the prefetch copy: the cases of tests/test_prefetch.py ----------------


def test_prefetch_preserves_order_and_items():
    assert list(prefetch(range(100))) == list(range(100))


def test_prefetch_overlaps_producer_and_consumer():
    def slow_producer():
        for i in range(5):
            time.sleep(0.05)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch(slow_producer(), depth=2):
        time.sleep(0.05)  # consumer work
    elapsed = time.perf_counter() - t0
    # serial would be ~0.5 s; overlapped ≈ 0.3 s
    assert elapsed < 0.45, elapsed


def test_prefetch_propagates_exceptions():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_empty():
    assert list(prefetch([])) == []


def test_prefetch_passes_exception_objects_as_items():
    """The error envelope is a class of its own: an exception the producer
    yields (not raises) is an item like any other."""
    err = ValueError("an item")
    assert list(prefetch([1, err, (2, 3)])) == [1, err, (2, 3)]
