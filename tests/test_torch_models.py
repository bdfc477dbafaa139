"""The port's generators against the JAX package's, on the same weights.

Widths are ``__graft_entry__._tiny_cfg``'s, compute in f32; tolerance
atol = rtol = 1e-4 (the same math with sums in another order through a few
layers). Also pinned here: flax's tanh-GELU, flax ``SAME`` conv padding,
float32 output in stream order, flax's init rules, the weight converter's
refusals, and the full-width parameter counts of config 3 and of the BGRU
and BLSTM generators.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.config import ModelConfig, VocoderConfig
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models import build_generator, count_params
from percivaltts_tpu_torch.models.generators import gelu


def _cfg(kind="cnn_blstm", vocoder="pml", **model_kw):
    cfg = _tiny_cfg()
    model = dataclasses.replace(cfg.model, generator=kind, compute_dtype="float32", **model_kw)
    voc = dataclasses.replace(cfg.vocoder, kind=vocoder, mel_size=12)
    return model, voc, cfg.data.label_dim


def _pair(model_cfg, voc, label_dim, x, seed=0):
    """(jax output, port output, flax params) for one input batch."""
    jg = jax_build_generator(model_cfg, voc, label_dim)
    params = jg.init(jax.random.key(seed), jnp.asarray(x))
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    tg = build_generator(model_cfg, voc, label_dim)
    weights.load_flax_params(tg, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    return want, got, params


@pytest.mark.parametrize(
    "kind,vocoder,model_kw",
    [
        ("cnn_blstm", "pml", {}),
        ("cnn", "pml", {}),
        ("cnn_blstm", "world", {}),
        ("cnn", "melspec", {}),
        # an even kernel pads SAME asymmetrically (lo=1, hi=2)
        ("cnn_blstm", "pml", {"cnn_kernel_time": 4, "cnn_blocks": 2}),
        # the recurrent generators: front end, 2 layers of 16 units per
        # direction, readout; JAX on its scan path (f32 carries, as here)
        ("blstm", "pml", {"blstm_size": 32}),
        ("bgru", "world", {"blstm_size": 32}),
        # config 1's FC generator (dense_0 … dense_{n-1}, out), 3 layers
        ("fc", "pml", {"num_layers": 3}),
        ("fc", "world", {"num_layers": 3}),
    ],
)
def test_generator_matches_jax(kind, vocoder, model_kw):
    model_cfg, voc, L = _cfg(kind, vocoder, **model_kw)
    x = np.random.default_rng(1).normal(size=(2, 70, L)).astype(np.float32)
    want, got, _ = _pair(model_cfg, voc, L, x)
    assert got.dtype == np.float32 and got.shape == (2, 70, voc.feature_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bf16_generator_returns_float32_in_stream_order():
    model_cfg, voc, L = _cfg()
    model_cfg = dataclasses.replace(model_cfg, compute_dtype="bfloat16")
    tg = build_generator(model_cfg, voc, L)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 64, L)).astype(np.float32))
    with torch.no_grad():
        y = tg(x)
        y32 = build_generator(dataclasses.replace(model_cfg, compute_dtype="float32"), voc, L)(x)
    assert y.dtype == torch.float32 and y.shape == (2, 64, voc.feature_size)
    assert torch.isfinite(y).all()
    # same seed, same weights: bf16 stays near f32 column by column, so the
    # f0 | spec | nm streams sit where the f32 run puts them
    assert (y - y32).abs().max().item() < 0.1


def test_fc_generator_bf16_matches_flax():
    """Config 1's numerics at a tiny width: bf16 compute with f32 params,
    weights carried from flax. Each Dense rounds its product and its bias
    sum to bf16 (ulp 2^-8 relative) and the two frameworks may round a sum
    either way, so a one-ulp flip in a hidden unit reaches the output
    through the next layers. Tolerance 0.03 absolute on outputs of
    magnitude ~1 (a few bf16 ulps); the f32 run above agrees to 1e-4.
    Seen on the CPU: 0 (both round each product and sum alike)."""
    model_cfg, voc, L = _cfg("fc", num_layers=3)
    model_cfg = dataclasses.replace(model_cfg, compute_dtype="bfloat16")
    x = np.random.default_rng(5).normal(size=(2, 70, L)).astype(np.float32)
    want, got, _ = _pair(model_cfg, voc, L, x)
    assert got.dtype == np.float32 and got.shape == (2, 70, voc.feature_size)
    err = np.abs(got - want).max()
    print(f"FC bf16, port vs flax: max |diff| {err:.3g} (max |flax| {np.abs(want).max():.3g})")
    assert err <= 0.03


def test_config1_fc_generator_shape():
    """Config 1 at full width (3 × 256 tanh layers, 99 features): the flax
    tree's names and shapes map onto the port's FC generator one for one."""
    model_cfg, voc, L = ModelConfig(generator="fc"), VocoderConfig(), 425
    shapes = jax.eval_shape(
        jax_build_generator(model_cfg, voc, L).init,
        jax.random.key(0),
        jax.ShapeDtypeStruct((1, 64, L), jnp.float32),
    )
    flat = weights.flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert sorted(flat) == ["dense_0/bias", "dense_0/kernel", "dense_1/bias", "dense_1/kernel",
                            "dense_2/bias", "dense_2/kernel", "out/bias", "out/kernel"]
    tg = build_generator(model_cfg, voc, L)
    weights.load_flax_params(tg, flat)
    n = 425 * 256 + 256 + 2 * (256 * 256 + 256) + 256 * 99 + 99
    assert count_params(tg) == jax_count_params(shapes) == n


def test_gelu_is_flax_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), want, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()  # torch's default differs
    assert np.abs(erf - want).max() > 1e-4


def test_converter_refuses_missing_extra_and_misshapen_keys():
    model_cfg, voc, L = _cfg()
    x = np.zeros((1, 64, L), np.float32)
    params = jax_build_generator(model_cfg, voc, L).init(jax.random.key(0), jnp.asarray(x))
    flat = weights.flatten(jax.tree.map(np.asarray, params))
    assert "f0_blstm/fwd/hi" in flat and "spec_conv0a/kernel" in flat

    tg = build_generator(model_cfg, voc, L)
    missing = dict(flat)
    del missing["f0_blstm/bwd/ho"]
    with pytest.raises(KeyError, match="f0_blstm/bwd/ho"):
        weights.load_flax_params(tg, missing)
    extra = dict(flat, **{"critic/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="critic/kernel"):
        weights.load_flax_params(tg, extra)
    bad = dict(flat, **{"trunk_0/kernel": flat["trunk_0/kernel"][:-1]})
    with pytest.raises(ValueError, match="trunk_0/kernel"):
        weights.load_flax_params(tg, bad)


def test_npz_round_trip(tmp_path):
    model_cfg, voc, L = _cfg()
    x = np.random.default_rng(3).normal(size=(1, 64, L)).astype(np.float32)
    want, got, params = _pair(model_cfg, voc, L, x, seed=4)
    path = str(tmp_path / "generator.npz")
    weights.save_npz(path, jax.tree.map(np.asarray, params))
    tg = build_generator(model_cfg, voc, L)
    weights.load_flax_params(tg, weights.load_npz(path))
    with torch.no_grad():
        np.testing.assert_array_equal(tg(torch.from_numpy(x)).numpy(), got)


def test_config3_parameter_count():
    """Full-width config 3 (the ModelConfig defaults with the BiLSTM f0
    head, label dim 425): both packages hold 3,246,691 parameters."""
    model_cfg, voc, L = ModelConfig(generator="cnn_blstm"), VocoderConfig(), 425
    shapes = jax.eval_shape(
        jax_build_generator(model_cfg, voc, L).init,
        jax.random.key(0),
        jax.ShapeDtypeStruct((1, 64, L), jnp.float32),
    )
    assert jax_count_params(shapes) == 3_246_691
    assert count_params(build_generator(model_cfg, voc, L)) == 3_246_691


@pytest.mark.parametrize("kind,count", [("bgru", 726_371), ("blstm", 922_979)])
def test_recurrent_generator_parameter_count(kind, count):
    """Full width (the ModelConfig defaults: a 256-wide front end, 2 layers
    of 128 units per direction, label dim 425, 99 features): both packages
    hold the same count."""
    model_cfg, voc, L = ModelConfig(generator=kind), VocoderConfig(), 425
    shapes = jax.eval_shape(
        jax_build_generator(model_cfg, voc, L).init,
        jax.random.key(0),
        jax.ShapeDtypeStruct((1, 64, L), jnp.float32),
    )
    assert jax_count_params(shapes) == count
    assert count_params(build_generator(model_cfg, voc, L)) == count


@pytest.mark.parametrize("kind", ["blstm", "bgru"])
def test_recurrent_generator_rejects_layer_norm(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_generator(ModelConfig(generator=kind, gen_norm="layer"), VocoderConfig(), 13)


def test_init_follows_flax_rules_and_seed():
    model_cfg, voc, L = ModelConfig(generator="cnn_blstm"), VocoderConfig(), 425
    g = build_generator(model_cfg, voc, L, generator=torch.Generator().manual_seed(5))
    w = g.trunk_0.weight.detach().double()
    assert abs(w.std().item() * np.sqrt(L) - 1.0) < 0.02  # lecun: var 1/fan_in
    assert w.abs().max().item() * np.sqrt(L) <= 2.0 / 0.87962566103423978 + 1e-6
    cw = g.spec_conv0a.weight.detach().double()  # conv fan_in = k·C_in
    assert abs(cw.std().item() * np.sqrt(5 * 256) - 1.0) < 0.02
    H = g.f0_blstm.features
    for d in (g.f0_blstm.fwd, g.f0_blstm.bwd):
        for k in range(4):
            q = d.wh.detach().double()[:, k * H : (k + 1) * H]
            assert torch.allclose(q.T @ q, torch.eye(H, dtype=q.dtype), atol=1e-5)
        assert not d.b.detach().any()
    assert not g.spec_out.bias.detach().any()
    again = build_generator(model_cfg, voc, L, generator=torch.Generator().manual_seed(5))
    other = build_generator(model_cfg, voc, L, generator=torch.Generator().manual_seed(6))
    assert torch.equal(again.trunk_0.weight, g.trunk_0.weight)
    assert not torch.equal(other.trunk_0.weight, g.trunk_0.weight)


@pytest.mark.parametrize(
    "model_kw",
    [
        {"generator": "fc", "gen_norm": "layer"},
        {"generator": "cnn", "conv_style": "2d"},
        {"generator": "cnn_blstm", "gen_norm": "layer"},
    ],
)
def test_unported_variants_name_the_roadmap(model_kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_generator(ModelConfig(**model_kw), VocoderConfig(), 13)


def test_training_state_params_load_into_the_port():
    """What the README's export recipe saves: ``eval_params`` of a trainer
    state, flattened to the weights ``.npz``, loads into the port's
    generator and predicts what the JAX generator predicts."""
    from percivaltts_tpu.training.state import eval_params, make_gan_state

    cfg = _tiny_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    L = cfg.data.label_dim
    state = make_gan_state(cfg, L, seed=3)
    params = jax.tree.map(np.asarray, eval_params(state))
    tg = build_generator(cfg.model, cfg.vocoder, L)
    weights.load_flax_params(tg, params)
    x = np.random.default_rng(8).normal(size=(2, 64, L)).astype(np.float32)
    want = np.asarray(state.gen.apply_fn(eval_params(state), jnp.asarray(x)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
