"""The port's critic and losses against the JAX package's, on the same
weights and inputs.

Critic widths are small (hidden 32, 4 blocks: two stride-2 convs), compute
in f32; the flax parameters are perturbed before loading so the LayerNorm
scale/bias mapping is exercised. Tolerance atol = rtol = 1e-5 on scores and
input gradients: the same math with sums in another order through a few
layers. The reference-faithful ``conv_style="2d"`` critic (2-D convs of 4,
8, 8, 16, 16 channels over the masked (T, freq) image) is held at the same
tolerance. Losses and the on-device normalization: 1e-6.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.config import ModelConfig, VocoderConfig
from percivaltts_tpu.data.normalize import NormStats
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu.models.critic import build_critic as jax_build_critic
from percivaltts_tpu.training import losses as jax_losses
from percivaltts_tpu.training.ondevice import make_normalizing_step as jax_normalizing_step
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models import build_critic, count_params
from percivaltts_tpu_torch.models.critic import same_padding
from percivaltts_tpu_torch.training import losses
from percivaltts_tpu_torch.training.ondevice import make_normalizing_step

L = 11


def _model(norm, **kw):
    return ModelConfig(critic_hidden=32, critic_blocks=4, critic_norm=norm,
                       critic_channels=4, compute_dtype="float32", **kw)


def _inputs(B, T, voc, seed):
    rng = np.random.default_rng(seed)
    cmp = rng.normal(size=(B, T, voc.feature_size)).astype(np.float32)
    lab = rng.normal(size=(B, T, L)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    for b, n in enumerate(rng.integers(T // 2, T + 1, size=B)):
        mask[b, n:] = 0.0
    mask[-1] = 0.0  # an all-padding row: the score's denominator clamps to 1
    return cmp, lab, mask


def _pair(model_cfg, voc, B, T, seed):
    cmp, lab, mask = _inputs(B, T, voc, seed)
    jc = jax_build_critic(model_cfg, voc)
    params = jax.jit(jc.init)(jax.random.key(seed), *map(jnp.asarray, (cmp, lab, mask)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32)),
        params,
    )
    tc = build_critic(model_cfg, voc, L)
    weights.load_flax_params(tc, jax.tree.map(np.asarray, params))
    return jc, params, tc, (cmp, lab, mask)


@pytest.mark.parametrize("norm", ["none", "layer"])
@pytest.mark.parametrize("T", [16, 20])
def test_critic_and_input_gradient_match_jax(norm, T):
    _check_scores_and_input_gradient(_model(norm), T)


@pytest.mark.parametrize(
    "norm,kernel,T",
    [("none", 5, 16), ("layer", 5, 20), ("layer", 4, 16), ("none", 4, 20)],
)
def test_2d_critic_and_input_gradient_match_jax(norm, kernel, T):
    """The 2d style: 17 bands at k=5 pad (2, 2) at stride 2 (17 → 9 → 5);
    an even kernel pads each axis asymmetrically; the LayerNorm reduces the
    channel axis only; the merge reads the last block's 16 channels."""
    _check_scores_and_input_gradient(_model(norm, conv_style="2d", critic_kernel=kernel), T)


def _check_scores_and_input_gradient(model_cfg, T):
    voc = VocoderConfig(spec_size=17, nm_size=9)
    jc, params, tc, (cmp, lab, mask) = _pair(model_cfg, voc, B=3, T=T, seed=T)
    w = np.random.default_rng(5).normal(size=3).astype(np.float32)

    @jax.jit  # scores and the input gradient of Σ w·scores in one compile
    def scores_and_grad(x):
        d, vjp = jax.vjp(lambda xx: jc.apply(params, xx, jnp.asarray(lab), jnp.asarray(mask)), x)
        return d, vjp(jnp.asarray(w))[0]

    want, want_g = map(np.asarray, scores_and_grad(jnp.asarray(cmp)))

    x = torch.from_numpy(cmp).requires_grad_(True)
    got = tc(x, torch.from_numpy(lab), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=1e-5, rtol=1e-5)


def test_critic_without_rest_streams_matches_jax():
    """melspec has one stream: no rest_d* layers, a narrower merge."""
    voc = VocoderConfig(kind="melspec", mel_size=12)
    jc, params, tc, arrays = _pair(_model("none"), voc, B=2, T=16, seed=3)
    assert not hasattr(tc, "rest_d0")
    want = np.asarray(jax.jit(jc.apply)(params, *map(jnp.asarray, arrays)))
    with torch.no_grad():
        got = tc(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_strided_same_padding_puts_the_extra_tap_right():
    assert same_padding(16, 5, 2) == (1, 2)  # Conv1d(padding=2) would be (2, 2)
    assert same_padding(10, 5, 2) == (1, 2)
    assert same_padding(9, 5, 2) == (2, 2)
    assert same_padding(16, 5, 1) == (2, 2)
    assert same_padding(16, 4, 1) == (1, 2)


def test_critic_refuses_time_not_divisible_by_its_stride_and_2d():
    """Both styles refuse a length their total stride does not divide, and
    a ``conv_style`` the JAX package does not know raises its
    ``ValueError`` (the 2d style, which waited for the port, builds)."""
    voc = VocoderConfig(spec_size=17, nm_size=9)
    cmp, lab, mask = map(torch.from_numpy, _inputs(1, 18, voc, seed=0))
    for style in ("time1d", "2d"):
        tc = build_critic(_model("none", conv_style=style), voc, L)  # total stride 4
        with pytest.raises(ValueError, match="stride 4"):
            tc(cmp, lab, mask)
    with pytest.raises(ValueError, match="unknown conv_style"):
        build_critic(_model("none", conv_style="3d"), voc, L)


@pytest.mark.parametrize("norm,count", [("none", 1_009_345), ("layer", 1_010_113)])
def test_2d_critic_parameter_count(norm, count):
    """The 2d critic at full width (32 → 64, 64, 128, 128 channels, 5×5,
    hidden 256, label dim 425, 99 features): both packages hold the same
    count, 768 more with the four channel LayerNorms."""
    model_cfg, voc, T = ModelConfig(conv_style="2d", critic_norm=norm), VocoderConfig(), 64
    shapes = jax.eval_shape(
        jax_build_critic(model_cfg, voc).init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, T, voc.feature_size), jnp.float32),
        jax.ShapeDtypeStruct((1, T, 425), jnp.float32),
        jax.ShapeDtypeStruct((1, T), jnp.float32),
    )
    assert jax_count_params(shapes) == count
    assert count_params(build_critic(model_cfg, voc, 425)) == count


def test_config3_critic_parameter_count():
    model_cfg, voc = ModelConfig(generator="cnn_blstm"), VocoderConfig()
    T = 64
    shapes = jax.eval_shape(
        jax_build_critic(model_cfg, voc).init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, T, voc.feature_size), jnp.float32),
        jax.ShapeDtypeStruct((1, T, 425), jnp.float32),
        jax.ShapeDtypeStruct((1, T), jnp.float32),
    )
    assert count_params(build_critic(model_cfg, voc, 425)) == jax_count_params(shapes)


def _feats(seed, B=3, T=24, D=7):
    rng = np.random.default_rng(seed)
    pred, target = rng.normal(size=(2, B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 15:] = 0.0
    mask[2, 3:] = 0.0
    return pred, target, mask


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_mse_and_rmse_match_jax(weighted):
    pred, target, mask = _feats(0)
    rng = np.random.default_rng(1)
    dw = rng.uniform(0.5, 2.0, size=7).astype(np.float32) if weighted else None
    fw = rng.uniform(0.5, 2.0, size=mask.shape).astype(np.float32) if weighted else None
    want = jax_losses.masked_mse(*map(jnp.asarray, (pred, target, mask)),
                                 None if dw is None else jnp.asarray(dw),
                                 None if fw is None else jnp.asarray(fw))
    got = losses.masked_mse(*map(torch.from_numpy, (pred, target, mask)),
                            None if dw is None else torch.from_numpy(dw),
                            None if fw is None else torch.from_numpy(fw))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        losses.masked_rmse(*map(torch.from_numpy, (pred, target, mask))).item(),
        float(jax_losses.masked_rmse(*map(jnp.asarray, (pred, target, mask)))), rtol=1e-6)


@pytest.mark.parametrize("radius", [0, 2])
def test_transition_weights_match_jax(radius):
    _, target, mask = _feats(2)
    want = jax_losses.transition_weights(jnp.asarray(target), jnp.asarray(mask), 3.0, radius)
    got = losses.transition_weights(torch.from_numpy(target), torch.from_numpy(mask), 3.0, radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_stream_weight_vector_matches_jax():
    streams = VocoderConfig(spec_size=17, nm_size=9).streams
    sw = (("f0", 10.0), ("nm", 0.5))
    want = jax_losses.stream_weight_vector(streams, sw, 27)
    got = losses.stream_weight_vector(streams, sw, 27)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert losses.stream_weight_vector(streams, (), 27) is None


def test_normalizing_step_matches_jax():
    rng = np.random.default_rng(4)
    stats = [NormStats(shift=rng.normal(size=d).astype(np.float32),
                       scale=rng.uniform(0.5, 2.0, size=d).astype(np.float32)) for d in (L, 7)]
    lab = rng.normal(size=(2, 3, 24, L)).astype(np.float32)  # a stacked (n_critic) batch
    cmp = rng.normal(size=(2, 3, 24, 7)).astype(np.float32)
    mask = (rng.random((2, 3, 24)) < 0.7).astype(np.float32)
    identity = lambda state, *batches, **kw: (state, batches, kw)  # noqa: E731
    _, want, _ = jax_normalizing_step(identity, *stats)(
        None, {"lab": jnp.asarray(lab), "cmp": jnp.asarray(cmp), "mask": jnp.asarray(mask)})
    _, got, kw = make_normalizing_step(identity, *stats, device="cpu")(
        None, {"lab": torch.from_numpy(lab), "cmp": torch.from_numpy(cmp),
               "mask": torch.from_numpy(mask)}, eps=1)
    assert kw == {"eps": 1}
    for k in ("lab", "cmp", "mask"):
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), atol=1e-6)
    assert not got[0]["lab"][mask == 0].any()


def test_dataclass_configs_are_shared():
    """The port reads the JAX package's framework-free config as it is."""
    m = dataclasses.replace(ModelConfig(), critic_norm="layer")
    assert build_critic(m, VocoderConfig(), 5).norm == "layer"
