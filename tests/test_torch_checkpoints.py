"""The port's checkpoints (``training/checkpoints.py``) against the JAX
package's Orbax ``CheckpointManager``: the same retention (LatestN ∪
BestN) and best-step queries over one save sequence, a state that restores
bit for bit, the EMA reconciled both ways, and saves that are atomic."""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.training.checkpoints import CheckpointManager as JaxCheckpointManager
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
from percivaltts_tpu_torch.training.state import eval_params, make_gan_state
from percivaltts_tpu_torch.training.wgan import make_wgan_step

B, T = 2, 16

# metrics None, metrics without a score, improving scores, ties, a plateau
# of worse scores, a save that is not past the latest step (skipped), and
# score-less saves at the end
SEQUENCE = [
    (0, None), (1, {"valid": 0.5}), (2, {"valid": 0.4, "score": 5.0}), (3, {"score": 4.0}),
    (4, {"score": 3.0}), (5, None), (6, {"score": 3.0}), (7, {"score": 3.5}),
    (5, {"score": 0.1}), (8, {"score": 3.5}), (9, {"score": 6.0}), (10, {"valid": 1.0}),
    (11, {"score": 2.0}), (12, {"score": 2.0}), (13, None), (14, None), (15, {"score": 7.0}),
    (16, None), (17, None),
]


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_retention_and_best_queries_equal_orbax(tmp_path, keep):
    """After every save: the retained steps, ``latest_step``,
    ``best_step`` and ``best_score`` of both managers."""
    theirs = JaxCheckpointManager(str(tmp_path / "jax"), keep=keep)
    mine = CheckpointManager(str(tmp_path / "port"), keep=keep)
    for step, metrics in SEQUENCE:
        theirs.save(step, {"w": np.arange(4, dtype=np.float32) + step}, metrics=metrics)
        mine.save(step, {"w": torch.arange(4.0) + step}, metrics=metrics)
        assert mine.all_steps() == sorted(theirs._mgr.all_steps()), step
        assert mine.latest_step() == theirs.latest_step()
        assert mine.best_step() == theirs.best_step()
        assert mine.best_score() == theirs.best_score()
    theirs.close()
    # a manager opened on the directory (a resumed run) sees the same
    again = CheckpointManager(str(tmp_path / "port"), keep=keep)
    assert (again.all_steps(), again.best_step(), again.best_score()) == (
        mine.all_steps(), mine.best_step(), mine.best_score())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(str(s) for s in mine.all_steps())


def _cfg(ema_decay, **model_kw):
    cfg = Configuration.from_dict(_tiny_cfg().to_dict())
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32", dropout_rate=0.1,
                                  **model_kw),
        train=dataclasses.replace(cfg.train, ema_decay=ema_decay),
    )


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic

    def batch(lead=()):
        mask = (np.arange(T) < rng.integers(T // 2, T + 1, size=lead + (B, 1))).astype(np.float32)
        return {"lab": torch.from_numpy(rng.normal(size=lead + (B, T, L)).astype(np.float32)),
                "cmp": torch.from_numpy(rng.normal(size=lead + (B, T, F)).astype(np.float32)),
                "mask": torch.from_numpy(mask)}

    return batch((nc,)), batch()


def _trained(cfg, steps=2, seed=3, flax_params=None):
    state = make_gan_state(cfg, cfg.data.label_dim, seed=seed, device="cpu")
    if flax_params is not None:
        weights.load_flax_params(state.gen, flax_params["gen"])
        weights.load_flax_params(state.critic, flax_params["critic"])
        state.ema = {n: p.detach().clone() for n, p in state.gen.named_parameters()}
    step = make_wgan_step(cfg.train)
    for i in range(steps):
        state, _ = step(state, *_batches(cfg, i))
    state.epoch = 4
    return state, step


def _assert_equal_trees(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_state_round_trips_bit_for_bit(tmp_path):
    """Both nets, both Adam states after 2 steps, the step generator (which
    drew the dropout masks and ε), the counters and the EMA; and a step
    taken from the restored state equals one taken from the original."""
    _check_round_trip(tmp_path, _cfg(ema_decay=0.9))


def test_2d_state_round_trips_bit_for_bit(tmp_path):
    """The same for the reference-faithful model (``conv_style="2d"``
    generator and critic, both with LayerNorms), trained from the JAX
    package's init of both nets carried by ``weights.py``: its Conv2d
    kernels, LayerNorms and their Adam moments restore bit for bit."""
    from percivaltts_tpu.models import build_generator as jax_build_generator
    from percivaltts_tpu.models.critic import build_critic as jax_build_critic

    cfg = _cfg(ema_decay=0.9, conv_style="2d", gen_norm="layer", critic_norm="layer")
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    lab, cmp, mask = np.zeros((1, T, L)), np.zeros((1, T, F)), np.ones((1, T))
    jg, jc = jax_build_generator(cfg.model, cfg.vocoder, L), jax_build_critic(cfg.model, cfg.vocoder)
    flax_params = {
        "gen": jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(1), lab)),
        "critic": jax.tree.map(np.asarray, jax.jit(jc.init)(jax.random.key(2), cmp, lab, mask)),
    }
    # the carried weights give the JAX outputs (f32, atol 1e-4)
    x = np.random.default_rng(4).normal(size=(2, T, L)).astype(np.float32)
    state, _ = _trained(cfg, steps=0, flax_params=flax_params)
    with torch.no_grad():
        got = state.gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jg.apply)(flax_params["gen"], x)), atol=1e-4)
    _check_round_trip(tmp_path, cfg, flax_params)


def _check_round_trip(tmp_path, cfg, flax_params=None):
    state, step = _trained(cfg, flax_params=flax_params)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.epoch - 1, state, metrics={"score": 1.0})
    fresh = make_gan_state(cfg, cfg.data.label_dim, seed=11, device="cpu")
    restored = mgr.restore(fresh)
    assert restored is fresh
    _assert_equal_trees(restored.state_dict(), state.state_dict())
    assert (restored.epoch, restored.step) == (4, 2)
    batches = _batches(cfg, 9)
    _, m_orig = step(state, *batches)
    _, m_rest = step(restored, *batches)
    _assert_equal_trees(m_rest, m_orig, "metrics")
    _assert_equal_trees(restored.state_dict(), state.state_dict())


def test_ema_is_reconciled_both_ways(tmp_path):
    """A checkpoint's EMA is restored into a state built without one (so
    ``eval_params`` serves it); a state that expects an EMA over a
    checkpoint without one gets it seeded from the restored parameters."""
    with_ema, _ = _trained(_cfg(ema_decay=0.9))
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(0, with_ema)
    plain_cfg = _cfg(ema_decay=0.0)
    restored = mgr.restore(make_gan_state(plain_cfg, plain_cfg.data.label_dim, device="cpu"))
    _assert_equal_trees(restored.ema, with_ema.ema, "ema")
    assert eval_params(restored) is restored.ema
    assert any(not torch.equal(restored.ema[n], p) for n, p in restored.gen.named_parameters())

    without_ema, _ = _trained(plain_cfg)
    assert without_ema.ema is None
    assert eval_params(without_ema).keys() == dict(without_ema.gen.named_parameters()).keys()
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(0, without_ema)
    ema_cfg = _cfg(ema_decay=0.9)
    restored = mgr.restore(make_gan_state(ema_cfg, ema_cfg.data.label_dim, seed=8, device="cpu"))
    live = {n: p.detach() for n, p in without_ema.gen.named_parameters()}
    _assert_equal_trees(restored.ema, live, "seeded ema")
    assert all(restored.ema[n].data_ptr() != p.data_ptr()
               for n, p in restored.gen.named_parameters())


def test_saves_are_atomic_and_a_leftover_tmp_is_ignored(tmp_path, monkeypatch):
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(make_gan_state(_cfg(0.0), 13, device="cpu"))
    (root / "3.tmp").mkdir()
    (root / "3.tmp" / "state.pt").write_bytes(b"half a checkpoint")
    reopened = CheckpointManager(str(root))
    assert reopened.latest_step() is None and reopened.best_step() is None

    def crash(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError):
        reopened.save(2, {"w": torch.zeros(2)})
    monkeypatch.undo()
    assert CheckpointManager(str(root)).latest_step() is None
    assert reopened.latest_step() is None and not (root / "2").exists()
    assert reopened.save(3, {"w": torch.ones(2)}, metrics={"score": 0.5})
    assert sorted(os.listdir(root)) == ["2.tmp", "3"]
    again = CheckpointManager(str(root))
    assert again.latest_step() == 3 and again.best_score() == (3, 0.5)
    _assert_equal_trees(again.load(3, "cpu"), {"w": torch.ones(2)})
