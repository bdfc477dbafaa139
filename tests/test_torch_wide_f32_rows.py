"""The few-row plan of the f32 cluster BPTTs (route ``"wide_f32"``, B <= 8)
on the CPU.

``csrc/wide_f32_few.cuh`` runs on the card only; what surrounds it is
replayed here (``ops/wide_f32_layout.py``): the rows a cluster its plan
takes (``bwd_plan``, held against the launchers' own plan on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 16), the shared
memory of every (H, R) it can choose, a BPTT with its products summed in the
kernels' order against the plain twins (``replay_bptt(..., few=True)``), the
twins against the JAX package's Pallas BPTTs in interpret mode, one f32
LSE step of config 3 at ``blstm_size=576`` (H = 288 a direction, a width the
plan takes) against the JAX package's step, and the parameter counts of the
``blstm_size=768`` models ``chip_smoke.py`` phase 16 trains against JAX's.

Tolerances, all f32: the replayed BPTT within 1e-6·max(1, max|v|) of the
twins (the same math, its products summed in another order over T = 3
steps); the twins within 1e-5·max(1, max|v|) of the Pallas kernels (over
T = 6); the LSE metrics rtol 2e-4 and the generator's Adam first moments
within 1e-3 of each parameter's largest moment, as the repo's other step
tests.
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
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu.training import lse as jax_lse
from percivaltts_tpu.training.state import make_gan_state as jax_make_gan_state
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models import build_generator, count_params
from percivaltts_tpu_torch.models.rnn import BiLSTM
from percivaltts_tpu_torch.ops import wide_f32_layout as wf
from percivaltts_tpu_torch.ops import wide_layout
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_bwd_reference, bilstm_fwd_reference
from percivaltts_tpu_torch.training.lse import lse_step
from percivaltts_tpu_torch.training.state import make_gan_state

H100_CLUSTERS = 7  # clusters of 12–16 blocks the H100 holds at once (chip_smoke.py phase 16a)
GATES = {"lstm": 4, "gru": 3}


# --- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("cell,H,B,R,waves", [
    ("lstm", 384, 8, 4, 1), ("lstm", 384, 5, 2, 1), ("lstm", 384, 3, 1, 1),
    ("lstm", 384, 2, 1, 1), ("lstm", 384, 1, 1, 1), ("lstm", 416, 6, 2, 1),
    ("lstm", 416, 8, 2, 2), ("lstm", 288, 8, 4, 1), ("gru", 384, 8, 4, 1), ("gru", 384, 2, 1, 1),
    ("gru", 512, 6, 2, 1), ("gru", 512, 8, 4, 1), ("gru", 512, 7, 4, 1), ("lstm", 416, 7, 1, 2)])
def test_few_rows_plan_at_the_kept_rows(cell, H, B, R, waves):
    """B <= 8 on the H100's 7 clusters: the rows of least waves × step
    estimate; the whole slice resident and nothing streamed."""
    r = wf.bwd_plan(B, H, GATES[cell], H100_CLUSTERS)
    assert (r.R, r.waves) == (R, waves)
    assert r.nres == len(wf.chunks(H)) and r.nstr == 0
    assert r.smem == wf.few_smem_bytes(H, GATES[cell], R)


@pytest.mark.parametrize("cell,H,B", [("lstm", 448, 8), ("lstm", 512, 2), ("lstm", 384, 9),
                                      ("gru", 512, 32), ("lstm", 288, 160)])
def test_wider_lstm_and_more_rows_keep_the_chunked_plan(cell, H, B):
    """No few-row block holds the LSTM's slice past H = 416, and past 8 rows
    the plan is the chunked one's (``rows``)."""
    gates = GATES[cell]
    assert wf.bwd_plan(B, H, gates, H100_CLUSTERS) == wf.rows(B, H, gates, H100_CLUSTERS)
    assert wf.bwd_plan(B, H, gates, H100_CLUSTERS).R >= 8


@pytest.mark.parametrize("gates", [4, 3])
def test_every_few_rows_block_fits_shared_memory(gates):
    """Every (H, R) the few-row plan can choose holds its slice, rows, partials
    and two buffers of slots within 232,448 bytes beside its mbarriers; it
    takes every R at each GRU width and every LSTM width up to 384, R <= 2 at
    the LSTM's 416, none past."""
    low = 256 if gates == 4 else 320
    for Hp in range(wf.padded(low + 1), 513, wf.K_GRANULE):
        for R in wf.FEW_ROWS:
            smem = wf.few_smem_bytes(Hp, gates, R)
            p = wide_layout.plan(Hp, gates)
            assert smem == 4 * (Hp * p.NC + R * Hp + 5 * R * p.NC + 2 * p.U * R * p.Hb)
            if wf.few_fits(Hp, gates, R):
                assert smem + wf.FEW_STATIC_SMEM <= wf.SMEM_OPTIN == 232_448
                assert wf.few_threads(Hp, gates) == 4 * p.NC in (384, 512)
            want = gates == 3 or Hp <= 384 or (Hp == 416 and R <= 2)
            assert wf.few_fits(Hp, gates, R) == want, (Hp, R)


def test_forced_rows():
    """``only`` forces R: a few-row R that does not fit raises, a chunked R
    takes the chunked plan at any B."""
    assert wf.bwd_plan(8, 384, 4, H100_CLUSTERS, only=2).R == 2
    assert wf.bwd_plan(160, 384, 4, H100_CLUSTERS, only=4).waves == -(-80 // H100_CLUSTERS)
    assert wf.bwd_plan(2, 384, 4, H100_CLUSTERS, only=8) == wf.rows(2, 384, 4, H100_CLUSTERS, 8)
    with pytest.raises(ValueError, match="R=4"):
        wf.bwd_plan(8, 416, 4, H100_CLUSTERS, only=4)
    with pytest.raises(ValueError, match="R=1"):
        wf.bwd_plan(1, 512, 4, H100_CLUSTERS, only=1)


# --- the sums ------------------------------------------------------------------


def _bptt_inputs(cell, T, B, H, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    G = GATES[cell] * H
    gx_f, gx_b = t(T, B, G), t(T, B, G)
    wh_f, wh_b = t(H, G, sc=H ** -0.5), t(H, G, sc=H ** -0.5)
    dy_f, dy_b = t(T, B, H), t(T, B, H)
    z = torch.zeros(1, B, H)
    if cell == "lstm":
        yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
        return (gx_f, gx_b, wh_f, wh_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
                torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, dy_f, dy_b)
    bn_f, bn_b = t(H, sc=0.1), t(H, sc=0.1)
    yf, yb = bigru_fwd_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    return (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            dy_f, dy_b)


@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("cell,H", [("lstm", 288), ("lstm", 384), ("lstm", 416), ("gru", 384),
                                    ("gru", 512)])
def test_replayed_few_rows_bptt_matches_the_twins(cell, H, B):
    """The BPTT summed as the few-row kernels sum it (the recompute as the
    forwards' product, the dh partials in four column lanes, the U block
    partials in block order) against ``bilstm_bwd_reference`` /
    ``bigru_bwd_reference``."""
    args = _bptt_inputs(cell, 3, B, H, seed=H + B)
    want = (bilstm_bwd_reference if cell == "lstm" else bigru_bwd_reference)(*args)
    got = wf.replay_bptt(cell, *args[:4], *args[4:], few=True)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-6 * scale


@pytest.mark.parametrize("cell,H", [("lstm", 288), ("gru", 384)])
def test_twins_match_the_pallas_bptt(cell, H):
    """The twins against ``_bilstm_bwd_pallas`` / ``_bigru_bwd_pallas`` in
    interpret mode (f32, B = 2, at a width where the JAX package takes its
    Pallas BPTT: ``pallas_vmem_ok`` and 4H / 3H a multiple of 128) on
    numpy-seeded inputs."""
    T, B = 6, 2
    rng = np.random.default_rng(31 + H)
    a = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    G = GATES[cell] * H
    ins = [a(T, B, G), a(T, B, G), a(H, G, sc=H ** -0.5), a(H, G, sc=H ** -0.5)]
    if cell == "lstm":
        ins += [a(T, B, H, sc=0.5) for _ in range(6)] + [a(T, B, H), a(T, B, H)]
        pallas, twin = lstm_pallas._bilstm_bwd_pallas, bilstm_bwd_reference
    else:
        ins += [a(H, sc=0.1), a(H, sc=0.1), a(T, B, H, sc=0.5), a(T, B, H, sc=0.5), a(T, B, H),
                a(T, B, H)]
        pallas, twin = lstm_pallas._bigru_bwd_pallas, bigru_bwd_reference
    assert lstm_pallas.pallas_vmem_ok(B, H, 4, cell)
    want = pallas(*map(jnp.asarray, ins), interpret=True)
    got = twin(*map(torch.from_numpy, ins))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


# --- config 3 at a width the plan takes, against JAX -----------------------------


def test_config3_f32_lse_step_at_blstm_size_576_matches_jax():
    """Config 3 (``cnn_blstm``) in f32 at ``blstm_size=576``: its f0 head's
    BiLSTM of H = 288 a direction, whose BPTT at B = 4 takes the few-row plan
    on the card (here its twin); one LSE step against the JAX package's on
    the same generator weights."""
    cfg = _tiny_cfg("lse")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, generator="cnn_blstm", blstm_size=576,
                                                compute_dtype="float32"))
    L, F = cfg.data.label_dim, cfg.vocoder.feature_size
    js = jax.jit(lambda: jax_make_gan_state(cfg, L, seed=9))()
    state = make_gan_state(cfg, L, seed=1, device="cpu")
    weights.load_flax_params(state.gen, jax.tree.map(np.asarray, js.gen.params))
    assert {m.features for m in state.gen.modules() if isinstance(m, BiLSTM)} == {288}
    assert wf.bwd_plan(4, 288, 4, H100_CLUSTERS).R <= 4
    rng = np.random.default_rng(13)
    B, T = 4, 24
    mask = np.ones((B, T), np.float32)
    mask[2, T - 5:] = 0.0
    batch = {"lab": (rng.normal(size=(B, T, L)) * mask[..., None]).astype(np.float32),
             "cmp": (rng.normal(size=(B, T, F)) * mask[..., None]).astype(np.float32),
             "mask": mask}
    jnew, jm = jax.jit(jax_lse.lse_step)(js, jax.tree.map(jnp.asarray, batch))
    state, m = lse_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=2e-4, err_msg=k)
    mus = weights._converted(state.gen, jax.tree.map(np.asarray, jnew.gen.opt_state[0].mu))
    for p, mu in mus:
        got = state.gen_opt.state[p]["exp_avg"].numpy()
        assert np.abs(got - mu).max() <= max(1e-3 * np.abs(mu).max(), 1e-6)


@pytest.mark.parametrize("kind,count", [("cnn_blstm", 4_822_115), ("bgru", 5_717_859)])
def test_blstm_size_768_parameter_counts_match_jax(kind, count):
    """``blstm_size=768`` in f32 at full width (label dim 425, 99 features),
    the models ``chip_smoke.py`` phase 16 trains at B = 8: the shapes JAX
    would initialise (``jax.eval_shape``, no compute) hold as many
    parameters as the port's model."""
    model_cfg = ModelConfig(generator=kind, blstm_size=768, compute_dtype="float32")
    voc, L = VocoderConfig(), 425
    shapes = jax.eval_shape(jax_build_generator(model_cfg, voc, L).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 64, L), jnp.float32))
    assert jax_count_params(shapes) == count
    assert count_params(build_generator(model_cfg, voc, L)) == count
