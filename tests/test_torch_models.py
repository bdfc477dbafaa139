"""The port's generators against the JAX package's, on the same weights.

Widths are ``__graft_entry__._tiny_cfg``'s, compute in f32; tolerance
atol = rtol = 1e-4 (the same math with sums in another order through a few
layers). The variants with ``gen_norm="layer"`` and ``conv_style="2d"``
load flax parameters perturbed by N(0, 0.1²), so that a LayerNorm's scale
and bias and every tap of a 2-D kernel are distinct. Also pinned here:
flax's tanh-GELU, flax ``SAME`` conv padding (per axis in 2d), float32
output in stream order, flax's init rules, the weight converter's
refusals, and the full-width parameter counts of config 3, of its 2d form
and of the BGRU and BLSTM generators.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

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


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32)),
        params,
    )


def _pair(model_cfg, voc, label_dim, x, seed=0, perturb=False):
    """(jax output, port output, flax params) for one input batch."""
    jg = jax_build_generator(model_cfg, voc, label_dim)
    params = jg.init(jax.random.key(seed), jnp.asarray(x))
    if perturb:
        params = _perturbed(params, seed + 1)
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
        # gen_norm="layer": a flax LayerNorm (eps 1e-6) after each trunk /
        # front-end Dense, none between the recurrent layers
        ("fc", "pml", {"num_layers": 3, "gen_norm": "layer"}),
        ("blstm", "pml", {"blstm_size": 32, "gen_norm": "layer"}),
        ("bgru", "world", {"blstm_size": 32, "gen_norm": "layer"}),
        ("cnn", "pml", {"gen_norm": "layer"}),
        ("cnn_blstm", "world", {"gen_norm": "layer"}),
        # conv_style="2d": the spectral stream as a (T, freq, 2) image under
        # 2-D convs of cnn_channels; an even kernel pads each axis
        # asymmetrically, and the two axes differently
        ("cnn", "pml", {"conv_style": "2d"}),
        ("cnn_blstm", "pml", {"conv_style": "2d", "cnn_blocks": 2}),
        ("cnn_blstm", "world", {"conv_style": "2d", "cnn_kernel_time": 4,
                                "cnn_kernel_freq": 2, "gen_norm": "layer"}),
        ("cnn", "melspec", {"conv_style": "2d", "cnn_kernel_time": 3, "cnn_kernel_freq": 6}),
    ],
)
def test_generator_matches_jax(kind, vocoder, model_kw):
    model_cfg, voc, L = _cfg(kind, vocoder, **model_kw)
    x = np.random.default_rng(1).normal(size=(2, 70, L)).astype(np.float32)
    perturb = model_kw.get("gen_norm") == "layer" or model_kw.get("conv_style") == "2d"
    want, got, _ = _pair(model_cfg, voc, L, x, perturb=perturb)
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
    """``gen_norm="layer"`` puts one LayerNorm, ``reg_fe_ln``, after the
    front end and none between the recurrent layers: the flax tree's keys
    are the port's one for one. A norm the JAX package does not know
    raises its ``ValueError``."""
    model_cfg, voc = ModelConfig(generator=kind, gen_norm="layer"), VocoderConfig()
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, 13).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, 13), jnp.float32))
    flat = weights.flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert sorted(k for k in flat if "_ln" in k) == ["reg_fe_ln/bias", "reg_fe_ln/scale"]
    weights.load_flax_params(build_generator(model_cfg, voc, 13), flat)
    with pytest.raises(ValueError, match="unknown gen_norm"):
        build_generator(ModelConfig(generator=kind, gen_norm="batch"), VocoderConfig(), 13)


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
    """The variants that waited for the port (ROADMAP queue 1 item 5) now
    build at full width with the flax tree's keys and shapes one for one,
    and a ``conv_style`` or ``gen_norm`` the JAX package does not know
    raises its ``ValueError``."""
    model_cfg, voc = ModelConfig(**model_kw), VocoderConfig()
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, 13).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, 13), jnp.float32))
    flat = weights.flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    tg = weights.load_flax_params(build_generator(model_cfg, voc, 13), flat)
    assert count_params(tg) == jax_count_params(shapes)
    with pytest.raises(ValueError, match="unknown"):
        build_generator(ModelConfig(**dict(model_kw, conv_style="3d", gen_norm="batch")), voc, 13)


@pytest.mark.parametrize("gen_norm,count", [("none", 847_397), ("layer", 848_421)])
def test_config3_2d_parameter_count(gen_norm, count):
    """The reference-faithful config 3 at full width (``conv_style="2d"``:
    the 256 → 130 ``spec_seed``, 32-channel 5×5 convs in 4 residual blocks,
    the BiLSTM f0 head; label dim 425, 99 features): both packages hold the
    same count, 1,024 more with the trunk's two LayerNorms."""
    model_cfg = ModelConfig(generator="cnn_blstm", conv_style="2d", gen_norm=gen_norm)
    voc, L = VocoderConfig(), 425
    shapes = jax.eval_shape(
        jax_build_generator(model_cfg, voc, L).init,
        jax.random.key(0),
        jax.ShapeDtypeStruct((1, 64, L), jnp.float32),
    )
    assert jax_count_params(shapes) == count
    assert count_params(build_generator(model_cfg, voc, L)) == count


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


@pytest.mark.parametrize("kind", ["fc", "blstm", "cnn"])
def test_generator_dropout_and_layernorm(kind):
    """The port's side of ``tests/test_models.py::
    test_generator_dropout_and_layernorm``: dropout adds no parameters and
    acts in training mode only, drawing from the given generator;
    ``gen_norm="layer"`` adds the flax tree's ``_ln`` parameters. The FC
    generator's training-mode output equals Dense → LayerNorm → dropout →
    tanh per layer (the JAX ``_reg`` order) rebuilt by hand on the same
    keep masks (atol 1e-6)."""
    from percivaltts_tpu_torch.models.base import layer_norm
    from percivaltts_tpu_torch.models.generators import dropout

    base = dict(generator=kind, hidden_size=32, num_layers=2, cnn_channels=4, cnn_blocks=1,
                blstm_size=16, blstm_layers=1, compute_dtype="float32")
    voc, L = VocoderConfig(spec_size=17, nm_size=9), 13
    lab = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, L)).astype(np.float32))
    g0 = build_generator(ModelConfig(**base), voc, L)
    gd = build_generator(ModelConfig(**base, dropout_rate=0.5), voc, L)
    assert [n for n, _ in g0.named_parameters()] == [n for n, _ in gd.named_parameters()]
    gd.load_state_dict(g0.state_dict())
    with torch.no_grad():
        y0, y_eval = g0(lab), gd(lab)
        y1 = gd(lab, train=True, generator=torch.Generator().manual_seed(1))
        y2 = gd(lab, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(y_eval, y0, rtol=0, atol=1e-6)
    assert not torch.allclose(y1, y_eval) and not torch.allclose(y1, y2)

    model_cfg = ModelConfig(**base, gen_norm="layer", dropout_rate=0.5)
    gl = build_generator(model_cfg, voc, L)
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, L).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 32, L), jnp.float32))
    flat = weights.flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    ln = sorted(k for k in flat if "_ln" in k)
    assert ln and ln == sorted(n.replace(".", "/").replace("weight", "scale")
                               for n, _ in gl.named_parameters() if "_ln" in n)
    with torch.no_grad():
        for p in gl.parameters():  # LayerNorm scales and biases away from 1 and 0
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        got = gl(lab, train=True, generator=torch.Generator().manual_seed(3))
        assert torch.isfinite(got).all()
        if kind == "fc":
            g, x = torch.Generator().manual_seed(3), lab
            for i in range(2):
                dense, norm = getattr(gl, f"dense_{i}"), getattr(gl, f"reg_{i}_ln")
                x = F.linear(x, dense.weight, dense.bias)
                x = torch.tanh(dropout(layer_norm(x, norm.weight, norm.bias), 0.5, g))
            torch.testing.assert_close(got, F.linear(x, gl.out.weight, gl.out.bias),
                                       rtol=0, atol=1e-6)
