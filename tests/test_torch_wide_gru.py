"""The GRU at every width the JAX package trains, on the CPU.

Past H = 320 (bf16: 128) the CUDA BiGRU runs the cluster kernels of the
"wide" route (``csrc/bigru_{fwd,bwd}_wide.cu``); their split of units over
a cluster (3 gates a unit, blocks of a multiple of 32 units) and the
per-block packing of ``W_h`` (``ops/wide_layout.py`` with ``gates=3``) are
replayed here in torch. The port's ``BiLSTM(cell_type="gru")`` and the BGRU
generator at such widths (on the kernels' plain twins, as every CPU tensor)
are held against the JAX package: H = 384 against the Pallas GRU in
interpret mode (its own domain: ``(3H) % 128 == 0``, inside its VMEM
budget), H = 512 against JAX's ``_gru_scan``, which ``_pick_pallas`` takes
for f32 at that width. The kernels themselves are held against the twins
on the card (``chip_smoke.py`` phase 14, ``tests/test_torch_cuda.py``).

Tolerances, all f32: the replayed products 1e-5 (unit-scale sums of up to
3H terms in another order); the layer's outputs 1e-5 (the same math, sums
in another order); its gradients 1e-4 of each gradient's largest |value|
(sums over T·B in another order); the generator's served features atol =
rtol = 1e-4 (denormalized, scales up to 2); the LSE metrics rtol 1e-4 and
the Adam first moments within 1e-3 of each parameter's largest moment, as
``tests/test_torch_training.py``.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses

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
from percivaltts_tpu_torch.ops.mma_layout import GRU_SIMT_MAX_H, bwd_route, fwd_route
from percivaltts_tpu_torch.training.lse import lse_step
from percivaltts_tpu_torch.training.state import make_gan_state

# --- the route table ----------------------------------------------------------


@pytest.mark.parametrize("dtype,H,route", [
    # bf16: the tensor cores for H a multiple of 16 up to 128, the one-block
    # kernel below 128 elsewhere, the cluster kernels past it (measured
    # faster at H = 256)
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 100, "simt"), (torch.bfloat16, 136, "wide"),
    (torch.bfloat16, 256, "wide"), (torch.bfloat16, 300, "wide"), (torch.bfloat16, 512, "wide"),
    (torch.bfloat16, 640, "wide"),
    # f32, the parity dtype: the one-block kernels' widths up to the
    # one-block BPTT's 320 ("simt" here; both passes take "narrow_f32" there),
    # then the cluster (321…341 was the forward/BPTT mismatch)
    (torch.float32, 128, "simt"), (torch.float32, 320, "simt"), (torch.float32, 321, "wide"),
    (torch.float32, 341, "wide"), (torch.float32, 384, "wide"), (torch.float32, 4096, "wide"),
    (torch.float32, 512, "wide"), (torch.float32, 544, "wide"),
])
def test_gru_route_table(dtype, H, route):
    # a cluster of blocks a direction ("wide" in the table) runs on the
    # tensor cores in bf16 up to H = 672 ("wide_mma"), on CUDA cores in f32;
    # a layer's backward takes its forward's route; in f32 up to H = 512 both
    # passes take the f32 cluster kernels ("wide_f32" past the one-block
    # widths), and at those widths "narrow_f32"
    want = "wide_mma" if dtype == torch.bfloat16 and route == "wide" else route
    f32_cluster = dtype == torch.float32 and want == "wide" and H <= 512
    f32_narrow = dtype == torch.float32 and want == "simt"
    assert fwd_route(dtype, H, "gru") == ("narrow_f32" if f32_narrow else
                                         "wide_f32" if f32_cluster else want)
    assert bwd_route(dtype, H, "gru") == ("wide_f32" if f32_cluster else
                                         "narrow_f32" if f32_narrow else want)
    assert GRU_SIMT_MAX_H[torch.float32] == 320


def test_gru_wide_plan_names_its_limit():
    for H in (0, wide_layout.GRU_MAX_H + 1):
        with pytest.raises(ValueError, match=f"BiGRU takes 1 <= H <= {wide_layout.GRU_MAX_H}"):
            wide_layout.plan(H, 3)
    with pytest.raises(ValueError, match="gates"):
        wide_layout.plan(64, 5)
    assert wide_layout.GRU_MAX_H == wide_layout.max_h(3) >= wide_layout.MAX_H == 4096


# --- the cluster split and the packing at gates = 3 ----------------------------

GRU_WIDTHS = [1, 7, 100, 321, 341, 352, 512, 640, 1024, wide_layout.GRU_MAX_H]


@pytest.mark.parametrize("H", GRU_WIDTHS)
def test_gru_plan_and_per_block_products(H):
    """Whole warps of columns, at most 16 blocks and 768 threads, every unit
    in exactly one block with its r, z and n columns, the last block not
    empty; the forward's product as the blocks' k-slices sum it and the
    BPTT's dgh·W_hᵀ as the blocks' partials meet in the owners equal the
    dense products (f32, 1e-5); packed columns past H are zero."""
    p = wide_layout.plan(H, 3)
    assert p.NC == 3 * p.Hb and p.NC % 32 == 0 and p.Hb % wide_layout.GRANULE[3] == 0
    assert 1 <= p.U <= wide_layout.MAX_CLUSTER and (p.U - 1) * p.Hb < H <= p.U * p.Hb
    assert p.NT == p.NC * p.KS <= wide_layout.THREADS[3] and p.KS & (p.KS - 1) == 0
    assert p.KS <= max(1, H) and wide_layout.gates_of(p) == 3
    cols = wide_layout.columns(H, p)
    assert cols.shape == (p.U, p.NC)
    assert torch.equal(cols[cols >= 0].sort().values, torch.arange(3 * H))
    unit = torch.where(cols >= 0, cols % H, -1)
    for b in range(p.U):  # the three gates of a block's units sit in that block
        units = unit[b][unit[b] >= 0]
        assert torch.equal(units.reshape(3, -1), units[: units.numel() // 3].repeat(3, 1))

    rng = np.random.default_rng(H)
    wh = torch.from_numpy((rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(3, H)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(3, 3 * H)).astype(np.float32))
    wp = wide_layout.pack_wh(wh, p)
    assert wp.shape == (p.U, H, p.NC) and wp.is_contiguous()
    assert (wp.permute(0, 2, 1)[cols < 0] == 0).all()
    np.testing.assert_allclose(wide_layout.replay_product(h, wp, p), h @ wh, atol=1e-5)
    np.testing.assert_allclose(wide_layout.replay_dh(dz, wp, p), dz @ wh.T, atol=1e-5)
    with pytest.raises(ValueError, match="not the plan"):
        wide_layout.pack_wh(wh, wide_layout.plan(H, 4))


# --- the f32 cluster BPTT's sums against the Pallas kernel ---------------------


def test_replayed_f32_bptt_matches_the_pallas_kernel():
    """The BPTT summed in the order of ``csrc/bigru_bwd_wide_f32.cu``
    (``wide_f32_layout.replay_bptt``: H = 384 in 6 chunks of 64 k, 12 blocks
    of 32 units, each owner adding its dh·z before the block partials)
    against ``_bigru_bwd_pallas`` in interpret mode (f32, its own domain: 3H
    a multiple of 128) on numpy-seeded inputs, within 1e-5·max(1, max|v|)."""
    T, B, H = 6, 3, 384
    rng = np.random.default_rng(23)
    a = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    ins = [a(T, B, 3 * H), a(T, B, 3 * H), a(H, 3 * H, sc=H ** -0.5), a(H, 3 * H, sc=H ** -0.5),
           a(H, sc=0.1), a(H, sc=0.1), a(T, B, H, sc=0.5), a(T, B, H, sc=0.5), a(T, B, H), a(T, B, H)]
    want = lstm_pallas._bigru_bwd_pallas(*map(jnp.asarray, ins), interpret=True)
    got = wide_f32_layout.replay_bptt("gru", *map(torch.from_numpy, ins))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


# --- the layer against JAX -----------------------------------------------------


def _grads_against_jax(H, use_pallas, T=12, B=2, D=48, seed=0):
    """(port, JAX) outputs and gradients (x, then every parameter in the
    port's order) of sum(y · dy) for one f32 BiGRU with the same weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    jm = JaxBiLSTM(H, compute_dtype="float32", cell_type="gru", use_pallas=use_pallas,
                   pallas_interpret=use_pallas)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))
    # nonzero biases, b_hn included: zeros would hide a misplaced one
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype)
                          if a.ndim == 1 else a, params)

    def loss(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * dy), y

    (_, y_j), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    tm = BiLSTM(D, H, compute_dtype="float32", cell_type="gru")
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    by_param = {id(p): v for p, v in weights._converted(tm, jax.tree.map(np.asarray, gp))}
    got = [xt.grad.numpy()] + [p.grad.numpy() for p in tm.parameters()]
    want = [np.asarray(gx)] + [by_param[id(p)] for p in tm.parameters()]
    return y.detach().numpy(), np.asarray(y_j), got, want


@pytest.mark.parametrize("H,use_pallas", [(384, True), (512, False)])
def test_wide_bigru_and_its_gradients_match_jax(H, use_pallas):
    assert fwd_route(torch.float32, H, "gru") == "wide_f32"
    y, y_j, got, want = _grads_against_jax(H, use_pallas)
    assert y.shape == (2, 12, 2 * H)
    np.testing.assert_allclose(y, y_j, atol=1e-5)
    assert len(got) == len(want) == 9  # x, and (wi, wh, b, b_hn) per direction
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


# --- the BGRU generator at a wide width ------------------------------------------


def test_full_width_bgru_parameter_count_matches_jax():
    """``generator="bgru"`` at ``blstm_size=1024`` (H = 512 a direction;
    label dim 425, 99 features): the shapes JAX would initialise
    (``jax.eval_shape``, no compute) hold as many parameters as the port's
    model."""
    model_cfg, voc, L = ModelConfig(generator="bgru", blstm_size=1024), VocoderConfig(), 425
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, L).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, L), jnp.float32))
    assert jax_count_params(shapes) == 9_983_075
    assert count_params(build_generator(model_cfg, voc, L)) == 9_983_075


def test_wide_bgru_generator_serves_and_steps_like_jax():
    """``generator="bgru"`` at ``blstm_size=672`` (H = 336 a direction, the
    widths 321…341 whose BPTT the one-block kernel refused) at the tiny
    config's other widths: 2 served requests (one padded chunk) and one LSE
    step against JAX on weights carried by ``weights.py``."""
    cfg = _tiny_cfg("lse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, generator="bgru", blstm_size=672,
                                                compute_dtype="float32"))
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    rng = np.random.default_rng(7)
    in_stats, out_stats = (NormStats(shift=rng.normal(size=d).astype(np.float32),
                                     scale=rng.uniform(0.5, 2.0, size=d).astype(np.float32))
                           for d in (L, F))
    js = jax.jit(lambda: jax_make_gan_state(cfg, L, seed=3))()
    state = make_gan_state(cfg, L, seed=1, device="cpu")
    weights.load_flax_params(state.gen, jax.tree.map(np.asarray, js.gen.params))
    layers = [m for m in state.gen.modules() if isinstance(m, BiLSTM)]
    assert {(m.cell_type, m.features) for m in layers} == {("gru", 336)} and len(layers) == 2

    labs = [(rng.normal(size=(n, L)) * 3 + 1).astype(np.float32) for n in (40, 61)]
    got = serve(state.gen, labs, in_stats, out_stats)
    jg = jax_build_generator(cfg.model, cfg.vocoder, L)
    preds = jax_predict_batch(jg.apply, js.gen.params,
                              [in_stats.normalize(x).astype(np.float32) for x in labs])
    for n, g, p in zip((40, 61), got, preds):
        assert g.shape == (n, F)
        np.testing.assert_allclose(g, out_stats.denormalize(p), atol=1e-4, rtol=1e-4)

    B, T = 2, 32
    mask = np.ones((B, T), np.float32)
    mask[1, T - 7:] = 0.0
    brng = np.random.default_rng(11)
    batch = {"lab": (brng.normal(size=(B, T, L)) * mask[..., None]).astype(np.float32),
             "cmp": (brng.normal(size=(B, T, F)) * mask[..., None]).astype(np.float32),
             "mask": mask}
    jnew, jm = jax.jit(jax_lse.lse_step)(js, jax.tree.map(jnp.asarray, batch))
    state, m = lse_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    mus = weights._converted(state.gen, jax.tree.map(np.asarray, jnew.gen.opt_state[0].mu))
    for p, mu in mus:
        got_mu = state.gen_opt.state[p]["exp_avg"].numpy()
        assert np.abs(got_mu - mu).max() <= max(1e-3 * np.abs(mu).max(), 1e-6)
