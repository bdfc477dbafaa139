"""The port's training steps against the JAX package's, from the same state.

Tiny widths (``__graft_entry__._tiny_cfg``: hidden 32, one conv block, a
BiLSTM f0 head of 8 units per direction, a 2-block critic of width 32),
f32 compute, B=4, T=32 with padded rows. One JAX step and one port step
from the same weights and fresh Adam states; the gradient penalty's ε is
the JAX step's own draw (``jax.random.split(state.key, n_critic + 3)``, as
``wgan.py:113-116`` and ``:77``), handed to the port.

Tolerances: metrics rtol 1e-4 (f32 sums in another order through the
critic's double backward); Adam moments within 1e-3 of each parameter's
max|moment|; parameters atol 1e-6, except where the gradient is below 1e-4
of its parameter's max, since Adam's first step is lr·g/(|g| + eps), close
to lr·sign(g), and flips sign with a rounding difference there.

Gradients below NOISE are rounding residue of sums that cancel: the
critic's score bias has a true gradient of 0 (a shift of every score
cancels in D(real) − D(fake) and leaves ∇ₓD unchanged), yet with the fused
2B pass both frameworks leave a residue of ~1e-8 that Adam turns into a
step of up to lr. So moments of such a parameter agree to NOISE (NOISE²
for the second moment), its entries are not compared, and the adversarial metrics are
compared with the score bias added back (every row here has valid frames,
so each score is its pooled sum plus the bias).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.training import losses as jax_losses
from percivaltts_tpu.training import lse as jax_lse
from percivaltts_tpu.training.state import make_gan_state as jax_make_gan_state
from percivaltts_tpu.training.wgan import make_wgan_step as jax_make_wgan_step
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models import build_generator
from percivaltts_tpu_torch.models.generators import dropout
from percivaltts_tpu_torch.training.losses import stream_weight_vector
from percivaltts_tpu_torch.training.lse import lse_eval_step, lse_eval_sums, lse_step
from percivaltts_tpu_torch.training.state import make_gan_state
from percivaltts_tpu_torch.training.wgan import make_wgan_step

B, T = 4, 32
NOISE = 1e-6


def _cfg(**train_kw):
    cfg = _tiny_cfg()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32", blstm_size=16),
        train=dataclasses.replace(cfg.train, **train_kw),
    )


@pytest.fixture(scope="module")
def jstate():
    """One JAX WGAN state (with an EMA copy) for every test here: the LSE
    steps read only its generator, and the WGAN step (``ema_decay=0``)
    leaves the EMA alone. Built under jit, which takes half the time of
    flax's eager init."""
    cfg = _cfg(ema_decay=0.5)
    return jax.jit(lambda: jax_make_gan_state(cfg, cfg.data.label_dim, seed=5))()


def _batch(rng, L, F, lead=()):
    mask = np.ones(lead + (B, T), np.float32)
    lengths = rng.integers(T // 2, T + 1, size=lead + (B,))
    mask[np.arange(T) >= lengths[..., None]] = 0.0
    return {
        "lab": (rng.normal(size=lead + (B, T, L)) * mask[..., None]).astype(np.float32),
        "cmp": (rng.normal(size=lead + (B, T, F)) * mask[..., None]).astype(np.float32),
        "mask": mask,
    }


def _to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state(cfg, jstate, L):
    """The port's state with the JAX state's weights and fresh optimizers."""
    state = make_gan_state(cfg, L, seed=1, device="cpu")
    weights.load_flax_params(state.gen, jax.tree.map(np.asarray, jstate.gen.params))
    if state.critic is not None:
        weights.load_flax_params(state.critic, jax.tree.map(np.asarray, jstate.critic.params))
    return state


def _as_port_layout(module, tree):
    """A flax tree (parameters or moments) in the port's parameter layout."""
    return [v for _, v in weights._converted(module, jax.tree.map(np.asarray, tree))]


def _compare_update(module, opt, jts, b1):
    """Adam moments and parameters of one net against the JAX TrainState."""
    adam = jts.opt_state[0]
    mus = _as_port_layout(module, adam.mu)
    nus = _as_port_layout(module, adam.nu)
    params = _as_port_layout(module, jts.params)
    for p, mu, nu, want in zip(module.parameters(), mus, nus, params):
        st = opt.state[p]
        assert int(st["step"].item()) == int(adam.count)
        for got, ref, floor in ((st["exp_avg"], mu, NOISE), (st["exp_avg_sq"], nu, NOISE**2)):
            assert np.abs(got.numpy() - ref).max() <= max(1e-3 * np.abs(ref).max(), floor)
        g = np.abs(mu) / (1.0 - b1)  # the first moment's share of the gradient
        sure = g >= max(1e-4 * g.max(), NOISE)
        np.testing.assert_allclose(p.detach().numpy()[sure], want[sure], atol=1e-6)


# every option the step has, in one config (each config is a JAX compile of
# several seconds): the fused 2B critic pass, the penalty on every second
# critic update only (n_critic = 2, so one update with it and one without),
# boundary frame weights and per-stream LSE weights. The unfused pass is held
# against the fused one below.
WGAN_OPTIONS = {"critic_fused_pass": True, "gp_every": 2, "boundary_weight": 2.0,
                "stream_weights": (("f0", 4.0), ("nm", 0.5))}


def test_wgan_step_matches_jax(jstate):
    _check_wgan_step(_cfg(**WGAN_OPTIONS), jstate, seed=0)


def test_bgru_wgan_step_matches_jax():
    """The step with the BGRU generator (front end, 2 BGRU layers of 8
    units per direction, readout), default options; the JAX generator runs
    its GRU scan path (f32 carries, as the port's twins)."""
    cfg = _cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, generator="bgru"))
    jst = jax.jit(lambda: jax_make_gan_state(cfg, cfg.data.label_dim, seed=7))()
    _check_wgan_step(cfg, jst, seed=10)


def _check_wgan_step(cfg, jstate, seed):
    """One JAX step and one port step from ``jstate``'s weights, on the
    same batches and ε; metrics, then both nets' Adam moments and
    parameters."""
    L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic
    rng = np.random.default_rng(seed)
    critic_batches, gen_batch = _batch(rng, L, F, (nc,)), _batch(rng, L, F)
    jnew, jm = _jax_wgan_step(cfg)(
        jstate, jax.tree.map(jnp.asarray, critic_batches), jax.tree.map(jnp.asarray, gen_batch))
    _check_port_step(cfg, _port_state(cfg, jstate, L), jstate, jnew, jm, critic_batches, gen_batch)


def _jax_wgan_step(cfg):
    streams, sw, F = cfg.vocoder.streams, cfg.train.stream_weights, cfg.vocoder.feature_size
    return jax.jit(jax_make_wgan_step(cfg.train, jax_losses.stream_weight_vector(streams, sw, F)))


def _check_port_step(cfg, state, jstate, jnew, jm, critic_batches, gen_batch):
    """The port's step from ``state`` against the JAX step ``jstate`` →
    (``jnew``, metrics ``jm``) on the same batches, with the ε the JAX step
    drew from ``jstate.key``."""
    nc, F = cfg.train.n_critic, cfg.vocoder.feature_size
    _, _, _, *eps_keys = jax.random.split(jstate.key, nc + 3)
    eps = np.stack([np.asarray(jax.random.uniform(k, (B, 1, 1))) for k in eps_keys])
    step = make_wgan_step(cfg.train, stream_weight_vector(cfg.vocoder.streams,
                                                          cfg.train.stream_weights, F))
    before = state.step
    state, m = step(state, _to_t(critic_batches), _to_t(gen_batch), eps=torch.from_numpy(eps))
    assert set(m) == set(jm) == {"loss", "gen_adv", "lse", "w_dist", "gp"}
    bias = state.critic.score.bias.item(), float(jnew.critic.params["params"]["score"]["bias"][0])
    for k in m:
        shift = bias if k in ("loss", "gen_adv") else (0.0, 0.0)
        np.testing.assert_allclose(m[k].item() + shift[0], float(jm[k]) + shift[1],
                                   rtol=1e-4, err_msg=k)
    assert state.step == before + 1
    _compare_update(state.critic, state.critic_opt, jnew.critic, cfg.train.adam_b1)
    _compare_update(state.gen, state.gen_opt, jnew.gen, cfg.train.adam_b1)


@pytest.fixture(scope="module")
def jax_2d_steps():
    """The reference-faithful model at tiny width (``conv_style="2d"`` for
    the generator, 4-channel 5×5 convs, and the critic, 4 → 8, 8 channels;
    both with LayerNorms) and two JAX WGAN-GP steps from it (one compile)
    on numpy batches: (cfg, [state 0, 1, 2], [metrics 1, 2], [batches])."""
    cfg = _cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, conv_style="2d", gen_norm="layer",
                                                critic_norm="layer"))
    L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic
    states = [jax.jit(lambda: jax_make_gan_state(cfg, L, seed=9))()]
    rng = np.random.default_rng(12)
    batches = [(_batch(rng, L, F, (nc,)), _batch(rng, L, F)) for _ in range(2)]
    step, metrics = _jax_wgan_step(cfg), []
    for cb, gb in batches:
        j, m = step(states[-1], jax.tree.map(jnp.asarray, cb), jax.tree.map(jnp.asarray, gb))
        states.append(j)
        metrics.append(m)
    return cfg, states, metrics, batches


def test_2d_wgan_step_matches_jax(jax_2d_steps):
    """One step of the 2d model with both norms, from the JAX init's
    weights, at the tolerances above."""
    cfg, states, metrics, batches = jax_2d_steps
    state = _port_state(cfg, states[0], cfg.data.label_dim)
    assert state.gen.spec_in.weight.dim() == state.critic.spec_in.weight.dim() == 4
    _check_port_step(cfg, state, states[0], states[1], metrics[0], *batches[0])


def test_2d_adam_state_from_a_jax_step_continues_like_for_like(jax_2d_steps):
    """The port loads the JAX state after one step of the 2d model (both
    nets' weights and optax Adam moments, the Conv2d kernels and the
    LayerNorms among them) and takes the second step as JAX takes it."""
    cfg, states, metrics, batches = jax_2d_steps
    state = _port_state(cfg, states[1], cfg.data.label_dim)
    for opt, module, jts in ((state.gen_opt, state.gen, states[1].gen),
                             (state.critic_opt, state.critic, states[1].critic)):
        weights.load_optax_adam_state(opt, module, jax.tree.map(np.asarray, jts.opt_state[0]))
    state.step = 1
    _check_port_step(cfg, state, states[1], states[2], metrics[1], *batches[1])


def test_wgan_step_unfused_critic_pass_matches_fused():
    """Two critic calls (real, fake) score as one call on the 2B batch: the
    critic treats rows independently. Compared as the JAX parity above: the
    adversarial metrics with the score bias added back, rtol 1e-4."""
    rng = np.random.default_rng(6)
    runs = []
    for fused in (False, True):
        cfg = _cfg(**dict(WGAN_OPTIONS, critic_fused_pass=fused))
        L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic
        if not runs:
            cb, gb = _batch(rng, L, F, (nc,)), _batch(rng, L, F)
        state, m = make_wgan_step(cfg.train)(make_gan_state(cfg, L, seed=3, device="cpu"),
                                             _to_t(cb), _to_t(gb))
        bias = state.critic.score.bias.item()
        runs.append({k: v.item() + (bias if k in ("loss", "gen_adv") else 0.0)
                     for k, v in m.items()})
    for k in runs[0]:
        np.testing.assert_allclose(runs[0][k], runs[1][k], rtol=1e-4, err_msg=k)


# one compile each, shared by the tests below (the EMA update is in every
# step: the state carries an EMA copy)
_jax_lse_step = jax.jit(lambda s, b: jax_lse.lse_step(s, b, ema_decay=0.5))
_jax_lse_eval = jax.jit(lambda s, b: (jax_lse.lse_eval_step(s, b), *jax_lse.lse_eval_sums(s, b)))


def test_lse_step_and_eval_match_jax(jstate):
    cfg = _cfg(ema_decay=0.5)
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    state = _port_state(cfg, jstate, L)
    batch = _batch(np.random.default_rng(1), L, F)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = _to_t(batch)

    got = (lse_eval_step(state, tb), *lse_eval_sums(state, tb))
    for g, w in zip(got, _jax_lse_eval(jstate, jb)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)

    jnew, jm = _jax_lse_step(jstate, jb)
    state, m = lse_step(state, tb, ema_decay=0.5)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    _compare_update(state.gen, state.gen_opt, jnew.gen, cfg.train.adam_b1)


def test_fc_lse_step_matches_jax():
    """Config 1's trainer at a tiny width: the FC generator (2 × 32 tanh
    layers) and one LSE step with an EMA, from the same weights, at the
    tolerances above."""
    cfg = _cfg(ema_decay=0.5)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, generator="fc", num_layers=2),
                      train=dataclasses.replace(cfg.train, trainer="lse"))
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    js = jax.jit(lambda: jax_make_gan_state(cfg, L, seed=6))()
    state = _port_state(cfg, js, L)
    assert state.critic is None and sorted(dict(state.gen.named_children())) == [
        "dense_0", "dense_1", "out"]
    for (name, _), e in zip(state.gen.named_parameters(), _as_port_layout(state.gen, js.ema)):
        state.ema[name] = torch.from_numpy(e)
    batch = _batch(np.random.default_rng(3), L, F)
    jnew, jm = _jax_lse_step(js, jax.tree.map(jnp.asarray, batch))
    state, m = lse_step(state, _to_t(batch), ema_decay=0.5)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    _compare_update(state.gen, state.gen_opt, jnew.gen, cfg.train.adam_b1)
    for (name, _), want in zip(state.gen.named_parameters(), _as_port_layout(state.gen, jnew.ema)):
        np.testing.assert_allclose(state.ema[name].numpy(), want, atol=1e-6, err_msg=name)


def test_adam_state_from_a_trained_jax_state_continues_like_for_like(jstate):
    """Two JAX LSE steps; the port loads the state after the first (weights,
    optax moments at count 1, EMA) and takes the second."""
    cfg = _cfg(ema_decay=0.5)
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    rng = np.random.default_rng(2)
    b1, b2 = _batch(rng, L, F), _batch(rng, L, F)
    j1, _ = _jax_lse_step(jstate, jax.tree.map(jnp.asarray, b1))
    j2, jm = _jax_lse_step(j1, jax.tree.map(jnp.asarray, b2))

    state = _port_state(cfg, j1, L)
    weights.load_optax_adam_state(state.gen_opt, state.gen,
                                  jax.tree.map(np.asarray, j1.gen.opt_state[0]))
    ema = _as_port_layout(state.gen, j1.ema)
    for (name, _), e in zip(state.gen.named_parameters(), ema):
        state.ema[name] = torch.from_numpy(e)
    state, m = lse_step(state, _to_t(b2), ema_decay=0.5)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    _compare_update(state.gen, state.gen_opt, j2.gen, cfg.train.adam_b1)
    for (name, _), want in zip(state.gen.named_parameters(), _as_port_layout(state.gen, j2.ema)):
        np.testing.assert_allclose(state.ema[name].numpy(), want, atol=1e-6, err_msg=name)


def test_dropout_keeps_share_and_scales_kept():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    for rate in (0.1, 0.5):
        y = dropout(x, rate, g)
        assert abs((y == 0).float().mean().item() - rate) < 0.01
        kept = y[y != 0]
        assert torch.allclose(kept, torch.full_like(kept, 1.0 / (1.0 - rate)))
    assert not dropout(x, 1.0, g).any()


def test_generator_dropout_is_training_only():
    cfg = _cfg()
    L = cfg.data.label_dim
    lab = torch.from_numpy(np.random.default_rng(3).normal(size=(2, T, L)).astype(np.float32))
    model = lambda rate: build_generator(  # noqa: E731
        dataclasses.replace(cfg.model, dropout_rate=rate), cfg.vocoder, L,
        generator=torch.Generator().manual_seed(4))
    plain, dropping = model(0.0), model(0.4)
    with torch.no_grad():
        eval_out = plain(lab)
        assert torch.equal(dropping(lab), eval_out)  # eval mode never drops
        assert torch.equal(plain(lab, train=True, generator=torch.Generator()), eval_out)
        a = dropping(lab, train=True, generator=torch.Generator().manual_seed(9))
        b = dropping(lab, train=True, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and not torch.allclose(a, eval_out)
    with pytest.raises(ValueError, match="torch.Generator"):
        dropping(lab, train=True)


def test_wgan_step_draws_its_own_eps_and_keeps_grads_apart():
    """Without ε the step draws from ``state.rng``; two states from one seed
    take identical steps. After the step the critic's parameters accept
    gradients again and the generator's gradients came from its own loss."""
    cfg = _cfg()
    L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic
    rng = np.random.default_rng(8)
    cb, gb = _batch(rng, L, F, (nc,)), _batch(rng, L, F)
    step = make_wgan_step(cfg.train)
    runs = []
    for _ in range(2):
        state = make_gan_state(cfg, L, seed=3, device="cpu")
        critic_grads = [p.grad for p in state.critic.parameters()]
        state, m = step(state, _to_t(cb), _to_t(gb))
        runs.append((m, [p.detach().clone() for p in state.gen.parameters()]))
        assert all(p.requires_grad for p in state.critic.parameters())
        assert all(g is None for g in critic_grads)
        assert all(torch.isfinite(v) for v in m.values())
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_wgan_step_unfreezes_the_critic_when_the_generator_update_raises():
    cfg = _cfg()
    L, F, nc = cfg.data.label_dim, cfg.vocoder.feature_size, cfg.train.n_critic
    rng = np.random.default_rng(9)
    cb, gb = _batch(rng, L, F, (nc,)), _batch(rng, L + 1, F)  # a label too wide
    state = make_gan_state(cfg, L, seed=3, device="cpu")
    with pytest.raises(RuntimeError):
        make_wgan_step(cfg.train)(state, {k: torch.from_numpy(v) for k, v in cb.items()},
                                  {k: torch.from_numpy(v) for k, v in gb.items()})
    assert all(p.requires_grad for p in state.critic.parameters())
