"""The streamed BPTTs' deep layout (route ``"wide_mma_stream"`` past the 64-k
layout's widths), on the CPU.

Past H = 1536 (LSTM) / 1792 (GRU) a block of the streamed BPTT's 64-k layout
no longer fits the H100's 227 KB at 8 rows, and
``csrc/{bilstm,bigru}_bwd_wide_mma_stream.cu`` take their deep layout up to
H = 4096 (``ops/wide_mma_layout.py``: ``stream_plan``, ``deep_smem_bytes``,
``pack_wh_stream(…, chunk=32)``): 32-k chunks all streamed, each carrying
h_prev's rows; the dh partials through a scratch buffer in global memory;
PPW (unit group, 8-row tile) pairs a compute warp. Here: the plan at every
width and the batches the models run (rows, pairs, the kernels
instantiated, shared memory within ``SMEM_OPTIN``, scratch, waves); the
routes (the BPTT deep, the forward still ``"wide"``); the 32-k tiles'
swizzle and the packing's round trip; a BPTT whose products read the 32-k
tiles as the kernels address them, in their order, against "wide_mma"'s
replay (bit for bit in f32: the same sums) and the twins; the launchers'
refusals; one f32 layer at H = 2048 with its gradients against JAX's scan;
and the parameter counts of the models phase 18 of ``chip_smoke.py`` runs
(config 3 and the BGRU at ``blstm_size=4096``) against JAX's. The kernels
themselves are held against the twins on the card (``chip_smoke.py`` phase
18, ``tests/test_torch_cuda.py -k deep``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wide_mma_stream import _bptt_args, _bwd_inputs, _grads_against_jax, _replay_bptt

from percivaltts_tpu.config import ModelConfig as JaxModelConfig
from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu_torch import ModelConfig, VocoderConfig, _build
from percivaltts_tpu_torch.models import build_generator, count_params
from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_layout
from percivaltts_tpu_torch.ops import wide_mma_layout as wm
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_bwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

G_OF = {"lstm": 4, "gru": 3}
DEEP_FIRST = {4: 1568, 3: 1824}  # the first widths past the 64-k layout's (multiples of 32)
CLUSTERS = 7  # clusters of 12–16 blocks the H100 holds at once (chip_smoke.py phases 13–18)
BF16_TOL = 2e-2  # chip_smoke.py's KERNEL_TOL[bf16], of max(1, max|twin|)


# --- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 8, 32, 160])
@pytest.mark.parametrize("gates", [4, 3])
def test_deep_plan_at_every_width(gates, B):
    """From the first width past the 64-k layout to ``stream_bwd_max_h`` in
    steps of 32: the deep layout (32-k chunks, every one streamed, none
    resident, no buffer of partials in shared memory), R = 8, 16 or 24 at
    the fewest pairs a compute warp, up to ``DEEP_MAX_PPW``, whose kernel is
    instantiated, at least those the pairs need, the
    ring as many slots as fit (3 to ``DEEP_MAX_RING``), the shared memory
    ``deep_smem_bytes`` within ``SMEM_OPTIN``, the scratch
    two buffers of U × U × Hb × R f32, the waves of 2·ceil(B / R) clusters
    over the card's, and the plan no worse by its step estimate than any
    other R that fits; with the clusters a function of the shared memory, the
    same plan."""
    assert wm.stream_max_h(gates) + 32 == DEEP_FIRST[gates]
    for H in range(DEEP_FIRST[gates], wm.stream_bwd_max_h(gates) + 1, 32):
        p = wm.plan(H, gates)
        s = wm.stream_plan(B, H, gates, CLUSTERS)
        assert tuple(s[:3]) == tuple(p) and not wm.stream_fits(H, gates)
        assert (s.chunk, s.nres, s.nstr, s.dbuf) == (wm.DEEP_CHUNK, 0, H // wm.DEEP_CHUNK, 0)
        assert s.R % 8 == 0 and s.R <= wm.STREAM_MAX_ROWS
        assert wm.deep_ppw(H, gates, s.R) <= s.ppw <= wm.DEEP_MAX_PPW[gates]
        assert (s.R // 8, s.ppw) in wm.STREAM_DEEP_KERNELS[gates]
        assert s.ppw == wm.deep_kernel_ppw(H, gates, s.R)
        assert not any((s.R // 8, n) in wm.STREAM_DEEP_KERNELS[gates]
                       for n in range(wm.deep_ppw(H, gates, s.R), s.ppw))  # none fewer
        assert 15 * s.ppw >= p.Hb // wm.UNIT_GROUP[gates] * (s.R // 8)  # every pair held
        assert wm.deep_smem_bytes(H, gates, s.R) <= wm.SMEM_OPTIN  # at RING slots
        assert s.ring == wm.deep_ring(H, gates, s.R) and wm.RING <= s.ring <= wm.DEEP_MAX_RING
        assert s.smem == wm.deep_smem_bytes(H, gates, s.R, s.ring) <= wm.SMEM_OPTIN
        if s.ring < wm.DEEP_MAX_RING:  # one more slot would not fit
            assert wm.deep_smem_bytes(H, gates, s.R, s.ring + 1) > wm.SMEM_OPTIN
        assert s.scratch == 2 * p.U * p.U * p.Hb * s.R * 4 == wm.deep_scratch_bytes(H, gates, s.R)
        assert s.waves == -(-2 * -(-B // s.R) // CLUSTERS)
        assert wm.stream_plan(B, H, gates, lambda smem: CLUSTERS if smem else 0) == s
        cost = s.waves * wm.deep_step_ps(H, p.NC, s.R)
        for R in range(8, wm.STREAM_MAX_ROWS + 1, 8):
            if (wm.deep_kernel_ppw(H, gates, R) is None
                    or wm.deep_smem_bytes(H, gates, R) > wm.SMEM_OPTIN):
                continue
            assert cost <= -(-2 * -(-B // R) // CLUSTERS) * wm.deep_step_ps(H, p.NC, R)


@pytest.mark.parametrize("gates", [4, 3])
def test_deep_layout_takes_every_width_to_3840(gates):
    """The BPTT's widths end at ``stream_bwd_max_h``, ``MAX_H`` (4096: at
    8 rows the LSTM's 32 unit groups on the 4-pair kernel, the GRU's 16 on
    the 2-pair one; every width from 3840 on, which every width past it,
    holds), the forward's at ``stream_fwd_max_h`` (1536 / 1792); both run up
    to 16 rows a cluster at 2048, the LSTM up to 24 where its 3-tile kernel
    takes the pairs; a plan past 4096 raises naming the cell."""
    assert wm.stream_bwd_max_h(gates) == wm.DEEP_MAX_H == wide_layout.MAX_H == 4096
    assert wm.stream_fwd_max_h(gates) == wm.stream_max_h(gates) == (1536 if gates == 4 else 1792)
    assert all(wm.stream_bwd_fits(H, gates) for H in range(wm.max_h(gates) + 1, 4097, 16))
    assert not wm.stream_bwd_fits(4097, gates)
    assert {wm.stream_plan(B, 2048, gates, CLUSTERS).R for B in (8, 32, 160)} == {8, 16}
    # 32 / 16 unit groups at 8 rows: 3 / 2 pairs a warp needed, the 4- / 2-pair kernel taken
    assert (wm.deep_ppw(4096, gates, 8), wm.stream_plan(8, 4096, gates, CLUSTERS).ppw) == \
        ((3, 4) if gates == 4 else (2, 2))
    with pytest.raises(ValueError, match=f"streamed tensor-core wide {wide_layout.CELLS[gates]}"):
        wm.stream_plan(8, 4096 + 32, gates, CLUSTERS)


# --- the 32-k tiles ----------------------------------------------------------------


@pytest.mark.parametrize("gates,H", [(4, 1568), (4, 4096), (3, 1824), (3, 4096)])
def test_deep_tiles_are_free_of_bank_conflicts_and_round_trip(gates, H):
    """``pack_wh_stream(…, chunk=32)`` gives ``(U, H / 32, NC, 32)``: the
    ``pack_wh`` slices cut into 32-k chunks, each tile in the kernels'
    swizzled order (16-byte unit u of row p at u ^ ((p % 8) >> 1)), so that
    every ``ldmatrix`` (the recompute's rows at a k unit, the dh product's
    ``.trans`` rows at a unit column) reads 8 rows in 8 different 16-byte
    bank groups; unpacking gives the slices back."""
    p = wm.plan(H, gates)
    idx = wm.tile_index(p.NC, wm.DEEP_CHUNK)
    assert torch.equal(idx.flatten().sort().values, torch.arange(p.NC * wm.DEEP_CHUNK))
    # the 16-byte bank group of each row's unit u, for every 8 rows an ldmatrix reads
    groups = (idx[:, ::8] * 2 // 16 % 8).view(p.NC // 8, 8, wm.DEEP_CHUNK // 8)
    assert torch.equal(groups.sort(dim=1).values,
                       torch.arange(8)[None, :, None].expand_as(groups))
    # each unit's 8 elements stay together, in order, 16-byte aligned
    runs = idx.view(p.NC, wm.DEEP_CHUNK // 8, 8)
    assert torch.equal(runs - runs[..., :1], torch.arange(8).expand_as(runs))
    assert bool((runs[..., 0] % 8 == 0).all())
    wh = torch.from_numpy(np.random.default_rng(H).normal(size=(H, gates * H))).float()
    ws = wm.pack_wh_stream(wh, p, wm.DEEP_CHUNK)
    assert ws.shape == (p.U, H // wm.DEEP_CHUNK, p.NC, wm.DEEP_CHUNK) and ws.is_contiguous()
    wp = wm.pack_wh(wh, p)
    assert torch.equal(wm.unpack_wh_stream(ws, p, H), wp)
    got = ws[:, 3].reshape(p.U, -1)[:, idx.flatten()].view(p.U, p.NC, wm.DEEP_CHUNK)
    assert torch.equal(got, wp[:, :, 3 * wm.DEEP_CHUNK:4 * wm.DEEP_CHUNK])


# --- a BPTT through the 32-k tiles ---------------------------------------------------


def _deep_packing(monkeypatch):
    """Point ``pack_wh_stream`` at the deep layout's 32-k chunks for
    ``_replay_bptt``'s streamed BPTT."""
    pack = wm.pack_wh_stream
    monkeypatch.setattr(wm, "pack_wh_stream", lambda wh, p: pack(wh, p, wm.DEEP_CHUNK))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell,T,B,H", [("lstm", 3, 2, 1568), ("gru", 3, 2, 1824),
                                        ("lstm", 2, 1, 3840), ("gru", 2, 1, 3840),
                                        ("lstm", 2, 1, 4096), ("gru", 2, 1, 4096)])
def test_replayed_deep_bptt_equals_the_twin(monkeypatch, cell, T, B, H, dtype):
    """In f32 the BPTT through the deep layout's 32-k tiles equals "wide_mma"'s
    replay bit for bit (the recompute's k-steps and each unit's dh over the
    packed rows in order, the partials in block order: the chunk width moves
    no term) and the twin within 1e-5 of the largest gradient; with bf16
    inputs, and the dz tile rounded to bf16 where the kernels round it, it
    is within ``KERNEL_TOL[bf16]`` of the twin run in bf16."""
    _deep_packing(monkeypatch)
    args = _bptt_args(cell, T, B, H, dtype)
    want = (bilstm_bwd_reference if cell == "lstm" else bigru_bwd_reference)(*args)
    f32 = tuple(a.float() for a in args)
    got = _replay_bptt(cell, streamed=True, bf16=dtype == torch.bfloat16)(*f32)
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = 1e-5 if dtype == torch.float32 else BF16_TOL
        assert (g.to(dtype).float() - w.float()).abs().max().item() <= tol * scale
    if dtype == torch.float32:
        same = _replay_bptt(cell, streamed=False, bf16=False)(*f32)
        assert all(torch.equal(g, s) for g, s in zip(got, same))


# --- routes and launchers -----------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_deep_routes(cell):
    """bf16 past the 64-k layout's widths up to 4096 (odd widths padded to a
    multiple of 32): the BPTT takes "wide_mma_stream" at every B, the
    forward "wide"; up to the 64-k layout's widest both stream; f32 keeps
    "wide" for both past 512."""
    bf16, f32, gates = torch.bfloat16, torch.float32, G_OF[cell]
    last, top = wm.stream_max_h(gates), 4096
    for H in (last, last - 31):
        assert fwd_route(bf16, H, cell) == bwd_route(bf16, H, cell) == "wide_mma_stream"
    for H in list(range(last + 1, 4097, 97)) + [DEEP_FIRST[gates], 2000, 2048, 3072, 3840, 4096]:
        for B in (None, 1, 3, 8, 32, 160):
            assert bwd_route(bf16, H, cell, B) == ("wide_mma_stream" if H <= top else "wide")
            assert fwd_route(bf16, H, cell, B) == "wide"
        assert fwd_route(f32, H, cell) == bwd_route(f32, H, cell) == "wide"


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_launchers_refuse_what_the_deep_layout_does_not_take(monkeypatch, cell):
    """The streamed BPTT launchers refuse f32 (``TypeError``), a width past
    their limit, 4096 (``ValueError`` naming it) and an unknown route
    (``ValueError`` naming the routes), and the streamed forward launchers a
    deep width (``ValueError`` naming the forward's limit), all before the
    build; the BPTT wrappers count the route's launches by layout."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the launcher reached the build"))
    m, gates = (lstm_cuda, 4) if cell == "lstm" else (gru_cuda, 3)
    wrapper = lstm_cuda.bilstm_bwd if cell == "lstm" else gru_cuda.bigru_bwd
    assert set(wrapper.stream_layouts) == {"64k", "deep"}
    with pytest.raises(TypeError, match="bfloat16"):
        m.bwd_launch("wide_mma_stream", *_bwd_inputs(cell, 2, 1, 2048, torch.float32))
    top = wm.stream_bwd_max_h(gates)
    assert top == 4096
    with pytest.raises(ValueError, match=f"BPTTs take H <= {top}, got H={top + 32}"):
        m.bwd_launch("wide_mma_stream", *_bwd_inputs(cell, 2, 1, top + 32, torch.bfloat16))
    with pytest.raises(ValueError, match="takes the routes"):
        m.bwd_launch("wide_mma_deep", *_bwd_inputs(cell, 2, 1, 2048, torch.bfloat16))
    fwd_args = _bwd_inputs(cell, 2, 1, 2048, torch.bfloat16)[:4] + \
        (() if cell == "lstm" else _bwd_inputs(cell, 2, 1, 2048, torch.bfloat16)[4:6])
    with pytest.raises(ValueError, match=f"forwards take H <= {wm.stream_fwd_max_h(gates)}, "
                                         "got H=2048"):
        m.fwd_launch("wide_mma_stream", *fwd_args)


# --- the layers and the models against JAX ---------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_deep_width_layers_and_gradients_match_jax_scan(cell):
    """H = 2048, where the BPTT takes the deep layout in bf16, held in f32
    (the CPU runs the twins) against the JAX package's scan at T = 6,
    B = 2, on drawn weights (no orthogonal init): the outputs within 1e-5,
    each gradient within
    1e-4 of its largest |value| (as ``tests/test_torch_wide_mma_stream.py``
    holds H = 640 / 704; ``tests/test_torch_bf16_scan.py`` holds the bf16
    layer)."""
    y, y_j, got, want = _grads_against_jax(cell, 2048, T=6, drawn=True)
    assert y.shape == (2, 6, 4096)
    np.testing.assert_allclose(y, y_j, atol=1e-5)
    assert len(got) == len(want) == (7 if cell == "lstm" else 9)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("generator,count", [("cnn_blstm", 40_621_411), ("bgru", 153_178_211)])
def test_blstm_size_4096_parameter_counts_match_jax(generator, count):
    """Config 3 and the BGRU at ``blstm_size=4096`` (H = 2048 a direction;
    label dim 425, 99 features), the models phase 18 serves and trains: the
    shapes JAX would initialise (``jax.eval_shape``, no compute) hold as many
    parameters as the port's model."""
    L = 425
    shapes = jax.eval_shape(
        jax_build_generator(JaxModelConfig(generator=generator, blstm_size=4096),
                            JaxVocoderConfig(), L).init,
        jax.random.key(0), jax.ShapeDtypeStruct((1, 64, L), jnp.float32))
    assert jax_count_params(shapes) == count
    model = build_generator(ModelConfig(generator=generator, blstm_size=4096), VocoderConfig(), L)
    assert count_params(model) == count
