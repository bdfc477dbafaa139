"""The LSTM at every width the JAX package trains, on the CPU.

Past H = 256 (bf16: 128) the CUDA BiLSTM runs the cluster kernels of the
"wide" route (``csrc/bilstm_{fwd,bwd}_wide.cu``); their split of units over
a cluster and the per-block packing of ``W_h`` (``ops/wide_layout.py``) are
replayed here in torch. The port's ``BiLSTM`` and both recurrent
generators at such widths (on the kernels' plain twins, as every CPU
tensor) are held against the JAX package: H = 320 against the Pallas
kernels in interpret mode (their own domain: ``(4H) % 128 == 0``), H = 512
against JAX's scan path, which ``BiLSTM._pick_pallas`` takes for f32 at
that width. The kernels themselves are held against the twins on the card
(``chip_smoke.py`` phase 13, ``tests/test_torch_cuda.py``).

Odd widths: the CUDA-core BPTTs take H a multiple of 8 (LSTM) or 32
(GRU), and the wrappers zero-pad other widths to it
(``ops/lstm_cuda.py::at_width``); here the padded twins equal the unpadded
ones, and a BGRU generator whose layers run the padded twins takes one LSE
step as JAX does.

Tolerances, all f32: the layer's outputs 1e-5 (the same math, sums in
another order); its gradients 1e-4 of each gradient's largest |value| (sums
over T·B in another order); the generators' served features atol = rtol =
1e-4 (denormalized, scales up to 2); the LSE metrics rtol 1e-4 and the Adam
first moments within 1e-3 of each parameter's largest moment, as
``tests/test_torch_training.py``. The padding adds only exact zeros, but
the CPU's GEMMs may sum a padded product in another order: 1e-6.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from percivaltts_tpu.config import ModelConfig, VocoderConfig
from percivaltts_tpu.data.normalize import NormStats
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu.models.base import predict_batch as jax_predict_batch
from percivaltts_tpu.models.rnn import BiLSTM as JaxBiLSTM
from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu.training import lse as jax_lse
from percivaltts_tpu.training.state import make_gan_state as jax_make_gan_state
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.eval.serve import serve
from percivaltts_tpu_torch.models import build_generator, count_params
from percivaltts_tpu_torch.models.rnn import BiLSTM
from percivaltts_tpu_torch.ops import wide_f32_layout, wide_layout
from percivaltts_tpu_torch.ops.gru_cuda import (
    SIMT_BWD_GRANULE as GRU_GRANULE,
    bigru_bwd_reference,
    bigru_core,
    bigru_fwd_reference,
)
from percivaltts_tpu_torch.ops.lstm_cuda import (
    SIMT_BWD_GRANULE as LSTM_GRANULE,
    at_width,
    bilstm_bwd_reference,
    bilstm_fwd_reference,
)
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route
from percivaltts_tpu_torch.training.lse import lse_step
from percivaltts_tpu_torch.training.state import make_gan_state

# --- the route table ----------------------------------------------------------


@pytest.mark.parametrize("dtype,H,cell,route", [
    # bf16: the tensor cores for H a multiple of 16 up to 128
    (torch.bfloat16, 128, "lstm", "mma"), (torch.bfloat16, 16, "gru", "mma"),
    # bf16 elsewhere: the one-block kernels up to 128, the cluster kernels
    # past it (measured faster at H = 256, the LSTM's and the GRU's), on the
    # tensor cores
    (torch.bfloat16, 100, "lstm", "simt"), (torch.bfloat16, 136, "lstm", "wide"),
    (torch.bfloat16, 256, "lstm", "wide"), (torch.bfloat16, 512, "lstm", "wide"),
    (torch.bfloat16, 608, "lstm", "wide"), (torch.bfloat16, 300, "gru", "wide"),
    # f32, the parity dtype: the one-block kernels' widths up to 256 (GRU:
    # 320; "simt" here, where both passes take "narrow_f32"), then the cluster
    (torch.float32, 128, "lstm", "simt"), (torch.float32, 256, "lstm", "simt"),
    (torch.float32, 257, "lstm", "wide"), (torch.float32, 4096, "lstm", "wide"),
    (torch.float32, 341, "gru", "wide"), (torch.float32, 512, "lstm", "wide"),
    (torch.float32, 513, "lstm", "wide"),
])
def test_route_table(dtype, H, cell, route):
    # a cluster of blocks a direction ("wide" in the table) runs on the
    # tensor cores in bf16 up to H = 608 / 672 ("wide_mma"), on CUDA cores
    # in f32; a layer's backward takes its forward's route; in f32 up to
    # H = 512 both passes take the f32 cluster kernels ("wide_f32" past the
    # one-block widths), and at those widths "narrow_f32"
    want = "wide_mma" if dtype == torch.bfloat16 and route == "wide" else route
    f32_cluster = dtype == torch.float32 and want == "wide" and H <= 512
    f32_narrow = dtype == torch.float32 and want == "simt"
    assert fwd_route(dtype, H, cell) == ("narrow_f32" if f32_narrow else
                                         "wide_f32" if f32_cluster else want)
    assert bwd_route(dtype, H, cell) == ("wide_f32" if f32_cluster else
                                         "narrow_f32" if f32_narrow else want)


def test_route_refuses_other_cells_and_the_wide_plan_names_its_limit():
    with pytest.raises(ValueError, match="cell"):
        fwd_route(torch.float32, 64, "rnn")
    for H in (0, wide_layout.MAX_H + 1):
        with pytest.raises(ValueError, match=f"H <= {wide_layout.MAX_H}"):
            wide_layout.plan(H)
    assert wide_layout.MAX_H == 4096


# --- the cluster split and the packing ------------------------------------------

WIDE_WIDTHS = [1, 7, 100, 257, 264, 320, 512, 608, 1024, 4096]


@pytest.mark.parametrize("H", WIDE_WIDTHS)
def test_plan_splits_units_over_one_cluster(H):
    """Whole warps of columns, at most 16 blocks and 1024 threads, every
    unit in exactly one block with all four gates, the last block not
    empty."""
    p = wide_layout.plan(H)
    assert p.Hb % wide_layout.UNIT_GRANULE == 0 and p.NC == 4 * p.Hb
    assert 1 <= p.U <= wide_layout.MAX_CLUSTER and (p.U - 1) * p.Hb < H <= p.U * p.Hb
    assert p.NT == p.NC * p.KS <= wide_layout.MAX_THREADS and p.KS & (p.KS - 1) == 0
    assert p.KS <= max(1, H)
    cols = wide_layout.columns(H, p)
    assert cols.shape == (p.U, p.NC)
    held = cols[cols >= 0]
    assert torch.equal(held.sort().values, torch.arange(4 * H))
    unit = torch.where(cols >= 0, cols % H, -1)
    for b in range(p.U):  # the four gates of a block's units sit in that block
        units = unit[b][unit[b] >= 0]
        assert torch.equal(units.reshape(4, -1), units[: units.numel() // 4].repeat(4, 1))


@pytest.mark.parametrize("H", WIDE_WIDTHS[:-1])
def test_per_block_products_equal_the_dense_ones(H):
    """The forward's (and the recompute's) product as the blocks' k-slices
    sum it, and the BPTT's dz·W_hᵀ as the blocks' partials meet in the
    owners, equal the dense products (f64, to rounding); packed columns past
    H are zero."""
    rng = np.random.default_rng(H)
    p = wide_layout.plan(H)
    wh = torch.from_numpy(rng.normal(size=(H, 4 * H)))
    h = torch.from_numpy(rng.normal(size=(3, H)))
    dz = torch.from_numpy(rng.normal(size=(3, 4 * H)))
    wp = wide_layout.pack_wh(wh, p)
    assert wp.shape == (p.U, H, p.NC) and wp.is_contiguous()
    pad = wide_layout.columns(H, p) < 0
    assert (wp.permute(0, 2, 1)[pad] == 0).all()
    atol = 1e-11 * np.sqrt(H)  # f64 sums of H (or 4H) unit-variance terms, in another order
    np.testing.assert_allclose(wide_layout.replay_product(h, wp, p), h @ wh, atol=atol)
    np.testing.assert_allclose(wide_layout.replay_dh(dz, wp, p), dz @ wh.T, atol=atol)


def test_slices_cover_k_in_whole_float4s():
    for H in WIDE_WIDTHS:
        p = wide_layout.plan(H)
        KL = wide_layout.slice_length(H, p.KS)
        assert KL % 4 == 0 and KL * p.KS >= H and (KL - 4) * p.KS < H


# --- the f32 cluster BPTT's sums against the Pallas kernel ---------------------


def test_replayed_f32_bptt_matches_the_pallas_kernel():
    """The BPTT summed in the order of ``csrc/bilstm_bwd_wide_f32.cu``
    (``wide_f32_layout.replay_bptt``: H = 320 in 5 chunks of 64 k, 14 blocks
    of 24 units) against ``_bilstm_bwd_pallas`` in interpret mode (f32, its
    own domain: 4H a multiple of 128) on numpy-seeded inputs, within
    1e-5·max(1, max|v|)."""
    T, B, H = 6, 3, 320
    rng = np.random.default_rng(19)
    a = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    ins = [a(T, B, 4 * H), a(T, B, 4 * H), a(H, 4 * H, sc=H ** -0.5), a(H, 4 * H, sc=H ** -0.5)]
    ins += [a(T, B, H, sc=0.5) for _ in range(6)] + [a(T, B, H), a(T, B, H)]
    want = lstm_pallas._bilstm_bwd_pallas(*map(jnp.asarray, ins), interpret=True)
    got = wide_f32_layout.replay_bptt("lstm", *map(torch.from_numpy, ins))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


# --- the layer against JAX -----------------------------------------------------


def _grads_against_jax(H, use_pallas, T=16, B=2, D=64, seed=0):
    """(port, JAX) outputs and gradients (x, then every parameter in the
    port's order) of sum(y · dy) for one f32 BiLSTM with the same weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    jm = JaxBiLSTM(H, compute_dtype="float32", use_pallas=use_pallas, pallas_interpret=use_pallas)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))

    def loss(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * dy), y

    (_, y_j), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    tm = BiLSTM(D, H, compute_dtype="float32")
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    by_param = {id(p): v for p, v in weights._converted(tm, jax.tree.map(np.asarray, gp))}
    got = [xt.grad.numpy()] + [p.grad.numpy() for p in tm.parameters()]
    want = [np.asarray(gx)] + [by_param[id(p)] for p in tm.parameters()]
    return y.detach().numpy(), np.asarray(y_j), got, want


@pytest.mark.parametrize("H,use_pallas", [(320, True), (512, False)])
def test_wide_bilstm_and_its_gradients_match_jax(H, use_pallas):
    y, y_j, got, want = _grads_against_jax(H, use_pallas)
    assert y.shape == (2, 16, 2 * H)
    np.testing.assert_allclose(y, y_j, atol=1e-5)
    assert len(got) == len(want) == 7  # x, and (wi, wh, b) per direction
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


# --- the generators at a wide LSTM ----------------------------------------------


def _wide_cfg(kind, blstm_size, trainer="lse"):
    cfg = _tiny_cfg(trainer)
    model = dataclasses.replace(cfg.model, generator=kind, blstm_size=blstm_size,
                                compute_dtype="float32")
    return cfg.replace(model=model)


def _stats(rng, dim):
    return NormStats(shift=rng.normal(size=dim).astype(np.float32),
                     scale=rng.uniform(0.5, 2.0, size=dim).astype(np.float32))


def _batch(rng, L, F, B=2, T=32):
    mask = np.ones((B, T), np.float32)
    mask[1, T - 7:] = 0.0
    return {"lab": (rng.normal(size=(B, T, L)) * mask[..., None]).astype(np.float32),
            "cmp": (rng.normal(size=(B, T, F)) * mask[..., None]).astype(np.float32),
            "mask": mask}


def _states(cfg, seed):
    """A JAX LSE state and the port's, with the same generator weights."""
    L = cfg.data.label_dim
    js = jax.jit(lambda: jax_make_gan_state(cfg, L, seed=seed))()
    state = make_gan_state(cfg, L, seed=1, device="cpu")
    weights.load_flax_params(state.gen, jax.tree.map(np.asarray, js.gen.params))
    return js, state


def _lse_against_jax(cfg, js, state, seed, core=None):
    """One LSE step of the port (its recurrent layers' ``core`` replaced
    when given) and of JAX from the same generator weights: metrics and
    the generator's Adam first moments."""
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    if core is not None:
        for m in state.gen.modules():
            if isinstance(m, BiLSTM):
                m.core = core
    batch = _batch(np.random.default_rng(seed), L, F)
    jnew, jm = jax.jit(jax_lse.lse_step)(js, jax.tree.map(jnp.asarray, batch))
    state, m = lse_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    mus = weights._converted(state.gen, jax.tree.map(np.asarray, jnew.gen.opt_state[0].mu))
    for p, mu in mus:
        got = state.gen_opt.state[p]["exp_avg"].numpy()
        assert np.abs(got - mu).max() <= max(1e-3 * np.abs(mu).max(), 1e-6)


@pytest.mark.parametrize("kind", ["cnn_blstm", "blstm"])
def test_wide_generators_serve_and_step_like_jax(kind):
    """``blstm_size=640`` (H = 320 a direction): config 3's f0 head, or the
    BLSTM generator's 640-wide front end and 2 layers of 320, at the tiny
    config's other widths; 2 served requests (one padded chunk) and one LSE
    step against JAX on weights carried by ``weights.py``."""
    cfg = _wide_cfg(kind, 640)
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    rng = np.random.default_rng(7)
    in_stats, out_stats = _stats(rng, L), _stats(rng, F)
    js, state = _states(cfg, seed=3)
    widths = {m.features for m in state.gen.modules() if isinstance(m, BiLSTM)}
    assert widths == {320}
    labs = [(rng.normal(size=(n, L)) * 3 + 1).astype(np.float32) for n in (40, 61)]
    got = serve(state.gen, labs, in_stats, out_stats)
    jg = jax_build_generator(cfg.model, cfg.vocoder, L)
    preds = jax_predict_batch(jg.apply, js.gen.params,
                              [in_stats.normalize(x).astype(np.float32) for x in labs])
    for n, g, p in zip((40, 61), got, preds):
        assert g.shape == (n, F)
        np.testing.assert_allclose(g, out_stats.denormalize(p), atol=1e-4, rtol=1e-4)
    _lse_against_jax(cfg, js, state, seed=11)


@pytest.mark.parametrize("kind,count", [("cnn_blstm", 6_003_043), ("blstm", 13_128_803)])
def test_full_width_parameter_counts_match_jax(kind, count):
    """``blstm_size=1024`` at full width (label dim 425, 99 features): the
    shapes JAX would initialise (``jax.eval_shape``, no compute) hold as
    many parameters as the port's model."""
    model_cfg, voc, L = ModelConfig(generator=kind, blstm_size=1024), VocoderConfig(), 425
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, L).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, L), jnp.float32))
    assert jax_count_params(shapes) == count
    assert count_params(build_generator(model_cfg, voc, L)) == count


# --- odd widths: the zero padding of the CUDA-core BPTTs ---------------------------


def _lstm_args(T, B, H, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    gx_f, gx_b = t(rng.normal(size=(2, T, B, 4 * H)))
    wh_f, wh_b = t(rng.normal(size=(2, H, 4 * H)) / np.sqrt(H))
    yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
    z = torch.zeros_like(yf[:1])
    dy_f, dy_b = t(rng.normal(size=(2, T, B, H)))
    return ((gx_f, gx_b, wh_f, wh_b),
            (gx_f, gx_b, wh_f, wh_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
             torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, dy_f, dy_b))


def _gru_args(T, B, H, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    gx_f, gx_b = t(rng.normal(size=(2, T, B, 3 * H)))
    wh_f, wh_b = t(rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
    bn_f, bn_b = t(rng.normal(size=(2, H)))
    fwd = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    yf, yb = bigru_fwd_reference(*fwd)
    z = torch.zeros_like(yf[:1])
    dy_f, dy_b = t(rng.normal(size=(2, T, B, H)))
    return fwd, (*fwd, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), dy_f, dy_b)


def _padded_width(H, granule):
    """The kernel's width for H: the next multiple of the granule (H itself
    padded one granule further where it is a multiple already)."""
    return -(-(H + 1) // granule) * granule


@pytest.mark.parametrize("H", [40, 100])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_zero_padding_changes_no_unit(cell, H):
    """Forward and BPTT on gates, recurrent kernels (and b_hn) zero-padded
    to the CUDA-core BPTT's granule, cut back to H, equal the unpadded
    twins: every padded term is an exact 0, but the CPU's GEMMs block a
    product of another shape differently, so the same terms may be summed
    in another order (within 1e-6; 3.6e-7 seen)."""
    if cell == "lstm":
        fwd_args, bwd_args = _lstm_args(13, 3, H, seed=H)
        fwd, bwd, gates = bilstm_fwd_reference, bilstm_bwd_reference, 4
        Hp = _padded_width(H, LSTM_GRANULE)
        kw = {"with_cells": True}
    else:
        fwd_args, bwd_args = _gru_args(13, 3, H, seed=H)
        fwd, bwd, gates = bigru_fwd_reference, bigru_bwd_reference, 3
        Hp = _padded_width(H, GRU_GRANULE)
        kw = {}
    assert Hp > H
    for fn, args, extra in ((fwd, fwd_args, kw), (bwd, bwd_args, {})):
        want = fn(*args, **extra)
        got = at_width(fn, Hp, gates, *args, **extra)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
            assert (g - w).abs().max().item() <= 1e-6


def test_bgru_generator_on_padded_twins_steps_like_jax():
    """``generator="bgru"`` at ``blstm_size=80`` (H = 40, which the CUDA-core
    GRU BPTT runs padded to 64): its layers on the padded twins (forward and
    BPTT) take one LSE step as JAX does."""
    core = functools.partial(
        bigru_core,
        fwd=lambda *a: at_width(bigru_fwd_reference, 64, 3, *a),
        bwd=lambda *a: at_width(bigru_bwd_reference, 64, 3, *a),
    )
    cfg = _wide_cfg("bgru", 80)
    _lse_against_jax(cfg, *_states(cfg, seed=5), seed=5, core=core)
