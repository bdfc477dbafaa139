"""The streamed tensor-core cluster BPTTs (route ``"wide_mma_stream"``), on the CPU.

Past H = 608 (LSTM) / 672 (GRU) a block's ``W_hᵀ`` slice no longer fits its
shared memory beside the tiles, and ``csrc/bilstm_bwd_wide_mma_stream.cu`` /
``csrc/bigru_bwd_wide_mma_stream.cu`` stream it from L2 in chunks of 64 k
(``ops/wide_mma_layout.py``: ``stream_plan``, ``pack_wh_stream``). Here:
the plan at every width the route takes and the batches the models run
(rows, resident and streamed chunks, waves, shared memory within the H100's
227 KB); the chunk tiles' swizzle (the eight rows an ``ldmatrix`` reads in
eight bank groups) and the packing's round trip; a BPTT whose products read
the chunk tiles as the kernels address them, in their order, against
"wide_mma"'s replay (bit for bit: the same sums) and the twins (f32 within
1e-5 of the largest gradient, bf16 within ``KERNEL_TOL``'s 2e-2); the routes
at the edges of the tensor-core widths; the launchers' refusals; the f32
``BiLSTM`` at H = 640 and ``BiGRU`` at H = 704 with their gradients against
JAX's scan (the path the JAX package takes there: its Pallas BPTT does not
fit VMEM past LSTM 608 / GRU 640 in bf16), as ``tests/test_torch_wide_lstm.py``
holds H = 512 (atol 1e-5, gradients 1e-4 of each one's largest |value|);
and the parameter counts of the models phase 17 of ``chip_smoke.py`` runs
(config 3 and the BGRU at ``blstm_size=2048``) against JAX's. The kernels
themselves are held against the twins on the card (``chip_smoke.py`` phase
17, ``tests/test_torch_cuda.py -k wide_mma_stream``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.config import ModelConfig as JaxModelConfig
from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.models.base import count_params as jax_count_params
from percivaltts_tpu.models.rnn import BiLSTM as JaxBiLSTM
from percivaltts_tpu_torch import ModelConfig, VocoderConfig, _build, weights
from percivaltts_tpu_torch.models import build_generator, count_params
from percivaltts_tpu_torch.models.rnn import BiLSTM
from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_layout
from percivaltts_tpu_torch.ops import wide_mma_layout as wm
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_bwd_reference, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

G_OF = {"lstm": 4, "gru": 3}
FIRST = {4: 640, 3: 704}  # the first widths past "wide_mma"'s (multiples of 32 and 64)
CLUSTERS = 7  # clusters of 12–16 blocks the H100 holds at once (chip_smoke.py phases 13–17)
BF16_TOL = 2e-2  # chip_smoke.py's KERNEL_TOL[bf16], of max(1, max|twin|)


# --- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 8, 32, 160])
@pytest.mark.parametrize("gates", [4, 3])
def test_stream_plan_at_every_width(gates, B):
    """From the first width past "wide_mma" to the route's limit in steps of
    32: R = 8, 16 or 24 whose cells (a unit group and up to 2
    8-row tiles a warp) fit the 15 compute warps, two buffers of partial
    slots where they fit, every chunk resident or streamed (at least one
    streamed), as many resident as then fit, the shared
    memory within ``SMEM_OPTIN``, the waves of 2·ceil(B / R) clusters over
    the card's, and the plan no worse by its step estimate than any other R
    that fits."""
    for H in range(FIRST[gates], wm.stream_max_h(gates) + 1, 32):
        p = wm.plan(H, gates)
        s = wm.stream_plan(B, H, gates, CLUSTERS)
        assert tuple(s[:3]) == tuple(p)
        assert s.R % 8 == 0 and s.R <= wm.STREAM_MAX_ROWS
        assert wm.stream_cells(H, gates, s.R) < wm.STREAM_WARPS
        assert s.nres + s.nstr == wm.chunks(H) and s.nstr >= 1
        assert s.smem == wm.stream_smem_bytes(H, gates, s.R, s.nres, 1 + s.dbuf) <= wm.SMEM_OPTIN
        # two slot buffers wherever they fit; then one more resident chunk would not
        assert s.dbuf == (wm.stream_smem_bytes(H, gates, s.R, 0, 2) <= wm.SMEM_OPTIN)
        if s.nstr > 1:
            assert wm.stream_smem_bytes(H, gates, s.R, s.nres + 1, 1 + s.dbuf) > wm.SMEM_OPTIN
        assert s.waves == -(-2 * -(-B // s.R) // CLUSTERS)
        assert wm.stream_plan(B, H, gates, lambda smem: CLUSTERS if smem else 0) == s
        cost = s.waves * wm.stream_step_ps(H, p.NC, s.R, s.nstr)
        for R in range(8, wm.STREAM_MAX_ROWS + 1, 8):
            if (wm.stream_cells(H, gates, R) >= wm.STREAM_WARPS
                    or wm.stream_smem_bytes(H, gates, R, 0) > wm.SMEM_OPTIN):
                continue
            bufs = 1 + (wm.stream_smem_bytes(H, gates, R, 0, 2) <= wm.SMEM_OPTIN)
            nres = min(wm.chunks(H) - 1, (wm.SMEM_OPTIN - wm.stream_smem_bytes(H, gates, R, 0, bufs))
                       // wm.tile_bytes(p.NC))
            waves = -(-2 * -(-B // R) // CLUSTERS)
            assert cost <= waves * wm.stream_step_ps(H, p.NC, R, wm.chunks(H) - nres)


@pytest.mark.parametrize("gates", [4, 3])
def test_stream_widths_end_where_shared_memory_does(gates):
    """The 64-k layout takes every width from ``max_h`` to ``stream_max_h``
    (1536 LSTM, 1792 GRU: at 8 rows the ring, the h_prev tile, the partial
    slots and the dz tile fill the 227 KB there) and none past it up to
    ``wide_layout.MAX_H``; past it the BPTT's plan is the deep layout's
    (``tests/test_torch_wide_mma_stream_deep.py``), and a plan past
    ``MAX_H`` raises naming the cell."""
    assert (wm.max_h(gates), wm.stream_max_h(gates)) == ((608, 1536) if gates == 4 else (672, 1792))
    fits = [wm.stream_fits(H, gates) for H in range(wm.max_h(gates) + 1, wide_layout.MAX_H + 1)]
    n = wm.stream_max_h(gates) - wm.max_h(gates)
    assert all(fits[:n]) and not any(fits[n:])
    assert wm.stream_smem_bytes(wm.stream_max_h(gates), gates, 8, 0) <= wm.SMEM_OPTIN
    assert wm.stream_plan(8, wm.stream_max_h(gates) + 64, gates, CLUSTERS).chunk == wm.DEEP_CHUNK
    with pytest.raises(ValueError, match=f"streamed tensor-core wide {wide_layout.CELLS[gates]}"):
        wm.stream_plan(8, wide_layout.MAX_H + 64, gates, CLUSTERS)


# --- the chunk tiles -------------------------------------------------------------


@pytest.mark.parametrize("gates", [4, 3])
def test_chunk_tiles_are_free_of_bank_conflicts(gates):
    """Every ``ldmatrix`` of both products reads 8 rows of one 16-byte unit of
    a chunk tile (the recompute rows of a packed m-tile at a k unit, the dh
    product's ``.trans`` rows of 8 packed rows at a unit column); with the
    swizzle the 8 land in 8 different 16-byte bank groups of 128 bytes, so no
    read conflicts. Unswizzled (row p at 128·p) all 8 would hit one group."""
    NC = wm.plan(FIRST[gates], gates).NC
    idx = wm.tile_index(NC)
    assert sorted(idx.flatten().tolist()) == list(range(NC * wm.CHUNK))  # a permutation
    for p0 in range(0, NC, 8):
        for u in range(8):
            groups = (idx[p0:p0 + 8, 8 * u] * 2 // 16) % 8
            assert sorted(groups.tolist()) == list(range(8))
            # the unit's 8 elements stay together, in order, 16-byte aligned
            run = idx[p0:p0 + 8, 8 * u:8 * u + 8]
            assert torch.equal(run - run[:, :1], torch.arange(8).expand(8, 8))
            assert bool((run[:, 0] % 8 == 0).all())


@pytest.mark.parametrize("gates,H", [(4, 640), (4, 1024), (4, 1536), (3, 704), (3, 1056), (3, 1792)])
def test_stream_packing_round_trip(gates, H):
    """``pack_wh_stream`` gives ``(U, chunks, NC, 64)``: "wide_mma"'s
    ``pack_wh`` slices cut into 64-k chunks (H = 1056: the last chunk half,
    zero-padded), each tile in the kernels' swizzled order; unpacking gives
    the slices back."""
    p = wm.plan(H, gates)
    wh = torch.from_numpy(np.random.default_rng(H).normal(size=(H, gates * H))).float()
    ws = wm.pack_wh_stream(wh, p)
    assert ws.shape == (p.U, wm.chunks(H), p.NC, wm.CHUNK) and ws.is_contiguous()
    wp = wm.pack_wh(wh, p)
    assert torch.equal(wm.unpack_wh_stream(ws, p, H), wp)
    tiles = ws.reshape(p.U, wm.chunks(H), -1)
    idx = wm.tile_index(p.NC)
    for c in range(wm.chunks(H)):
        k = min(wm.CHUNK, H - c * wm.CHUNK)
        got = tiles[:, c][:, idx[:, :k].flatten()].view(p.U, p.NC, k)
        assert torch.equal(got, wp[:, :, c * wm.CHUNK:c * wm.CHUNK + k])
        assert not tiles[:, c][:, idx[:, k:].flatten()].any()  # the half chunk's padding


# --- a BPTT through the chunk tiles ------------------------------------------------


def _replay_bptt(cell, streamed: bool, bf16: bool):
    """A plain BPTT whose recompute and chained product run through the
    blocks' packed slices in the kernels' order: the streamed kernels' chunk
    tiles (``streamed``) or "wide_mma"'s slices; ``bf16`` rounds the dz
    tile to bf16 where the kernels do (the inputs are bf16 values)."""
    gates = G_OF[cell]
    recompute, dh_product = ((wm.replay_stream_recompute, wm.replay_stream_dh) if streamed
                             else (wm.replay_recompute, wm.replay_dh))
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)  # noqa: E731

    def core(*args):
        T, B, G = args[0].shape
        H = G // gates
        p = wm.plan(H, gates)
        pack = wm.pack_wh_stream if streamed else wm.pack_wh
        if cell == "lstm":
            gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b = args
            dirs = ((gx_f, wh_f, hp_f, cp_f, c_f, dy_f, range(T - 1, -1, -1)),
                    (gx_b, wh_b, hp_b, cp_b, c_b, dy_b, range(T)))
        else:
            gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b = args
            dirs = ((gx_f, wh_f, bn_f, hp_f, dy_f, range(T - 1, -1, -1)),
                    (gx_b, wh_b, bn_b, hp_b, dy_b, range(T)))
        outs = []
        for d in dirs:
            wp = pack(d[1], p)
            hp = d[2] if cell == "lstm" else d[3]
            dgx, dnr_out = torch.zeros_like(d[0]), torch.zeros(T, B, H)
            dh_c, dc = torch.zeros(B, H), torch.zeros(B, H)
            for t in d[-1]:
                z = recompute(hp[t], wp, p)
                if cell == "lstm":
                    zz = d[0][t] + z
                    i, f = torch.sigmoid(zz[:, :H]), torch.sigmoid(zz[:, H:2 * H])
                    g, o = torch.tanh(zz[:, 2 * H:3 * H]), torch.sigmoid(zz[:, 3 * H:])
                    tc = torch.tanh(d[4][t])
                    dh = d[5][t] + dh_c
                    dcn = dc + dh * o * (1 - tc * tc)
                    dg = rnd(torch.cat([dcn * g * i * (1 - i), dcn * d[3][t] * f * (1 - f),
                                        dcn * i * (1 - g * g), dh * tc * o * (1 - o)], -1))
                    dgx[t], dc = dg, dcn * f
                    dh_c = dh_product(dg, wp, p)
                else:
                    gx, bn = d[0][t], d[2]
                    r = torch.sigmoid(gx[:, :H] + z[:, :H])
                    zg = torch.sigmoid(gx[:, H:2 * H] + z[:, H:2 * H])
                    ghn = z[:, 2 * H:] + bn
                    n = torch.tanh(gx[:, 2 * H:] + r * ghn)
                    dh = d[4][t] + dh_c
                    dn = dh * (1 - zg) * (1 - n * n)
                    dr, dzz, dnr = (rnd(v) for v in (dn * ghn * r * (1 - r),
                                                     dh * (hp[t] - n) * zg * (1 - zg), dn * r))
                    dgx[t], dnr_out[t] = torch.cat([dr, dzz, rnd(dn)], -1), dnr
                    dh_c = dh_product(torch.cat([dr, dzz, dnr], -1), wp, p) + dh * zg
            outs.append((dgx, dnr_out))
        if cell == "lstm":
            return outs[0][0], outs[1][0]
        return outs[0][0], outs[1][0], outs[0][1], outs[1][1]

    return core


def _bptt_args(cell, T, B, H, dtype):
    """The BPTT's inputs from a forward pass of the twin, in ``dtype``."""
    gates = G_OF[cell]
    rng = np.random.default_rng(T + B + H)
    f = lambda *s, sc=1.0: torch.from_numpy(rng.normal(size=s) * sc).to(dtype)  # noqa: E731
    gx = [f(T, B, gates * H) for _ in range(2)]
    wh = [f(H, gates * H, sc=H ** -0.5) for _ in range(2)]
    if cell == "lstm":
        yf, yb, cf, cb = bilstm_fwd_reference(*gx, *wh, with_cells=True)
        z = torch.zeros_like(yf[:1])
        return (*gx, *wh, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
                torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, f(T, B, H), f(T, B, H))
    bn = [f(H) for _ in range(2)]
    yf, yb = bigru_fwd_reference(*gx, *wh, *bn)
    z = torch.zeros_like(yf[:1])
    return (*gx, *wh, *bn, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), f(T, B, H),
            f(T, B, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell,T,B,H", [("lstm", 9, 3, 640), ("gru", 9, 3, 704)])
def test_replayed_stream_bptt_equals_the_twin(cell, T, B, H, dtype):
    """In f32 the BPTT through the chunk tiles equals "wide_mma"'s replay bit
    for bit (the same terms in the same order) and the twin within 1e-5 of
    the largest gradient; with bf16 inputs, and the dz tile rounded to bf16
    where the kernels round it, it is within ``KERNEL_TOL[bf16]`` of the
    twin run in bf16."""
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
def test_bf16_routes_past_the_tensor_core_widths(cell):
    """bf16: up to ``max_h`` (608 / 672) both passes take "wide_mma"; past it
    both take "wide_mma_stream" up to ``stream_max_h`` (1536 / 1792), then
    the forward "wide" and the BPTT "wide_mma_stream" (its deep layout) up to
    ``stream_bwd_max_h`` (4096), but for the rows
    ``mma_layout.BF16_WIDE_BWD`` keeps the BPTT on "wide"; f32 keeps its
    routes (512: "wide_f32", 1024: "wide", 200: "narrow_f32")."""
    bf16, f32, gates = torch.bfloat16, torch.float32, G_OF[cell]
    first, last = wm.max_h(gates), wm.stream_max_h(gates)
    for H in (608, first):
        assert fwd_route(bf16, H, cell) == bwd_route(bf16, H, cell) == "wide_mma"
    for H in (640 if cell == "lstm" else 704, first + 1, 1000, 1024, last):
        assert (fwd_route(bf16, H, cell), bwd_route(bf16, H, cell)) == ("wide_mma_stream",) * 2
    for H in (last + 1, 2048, wm.stream_bwd_max_h(gates), wide_layout.MAX_H):
        deep = H <= wm.stream_bwd_max_h(gates)
        assert (fwd_route(bf16, H, cell), bwd_route(bf16, H, cell)) == \
            ("wide", "wide_mma_stream" if deep else "wide")
    # BF16_WIDE_BWD: the LSTM's H = 609–640 at B <= 3 keeps "wide" (measured
    # faster there in turns); every other batch and width streams
    for H in (first + 1, 624, 640) if cell == "lstm" else (first + 1, 704):
        for B in (1, 2, 3, 4, 8, 160):
            kept = cell == "lstm" and B <= 3
            assert bwd_route(bf16, H, cell, B) == ("wide" if kept else "wide_mma_stream")
    for B in (1, 2, 3):
        assert bwd_route(bf16, 672, cell, B) == ("wide_mma" if cell == "gru" else "wide_mma_stream")
        assert bwd_route(bf16, 704, cell, B) == "wide_mma_stream"
    if cell == "gru":
        assert fwd_route(bf16, 672, cell) == bwd_route(bf16, 672, cell) == "wide_mma"
    assert fwd_route(f32, 512, cell) == bwd_route(f32, 512, cell) == "wide_f32"
    assert fwd_route(f32, 1024, cell) == bwd_route(f32, 1024, cell) == "wide"
    assert bwd_route(f32, 200, cell) == "narrow_f32"


def _bwd_inputs(cell, T, B, H, dtype):
    gates = G_OF[cell]
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    if cell == "lstm":
        return (z(T, B, 4 * H), z(T, B, 4 * H), z(H, 4 * H), z(H, 4 * H)) + (z(T, B, H),) * 8
    return (z(T, B, gates * H), z(T, B, gates * H), z(H, 3 * H), z(H, 3 * H), z(H), z(H)) + \
        (z(T, B, H),) * 4


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_launchers_refuse_what_the_stream_route_does_not_take(monkeypatch, cell):
    """The BPTT launchers take "wide_mma_stream", and so do the forwards
    (``tests/test_torch_wide_mma_stream_fwd.py`` holds theirs); an unknown
    route name raises ``ValueError`` naming the routes, in either pass; the
    streamed route refuses f32 (``TypeError``) and a width past its limit
    (``ValueError`` naming it: the BPTT's ``stream_bwd_max_h``, 4096), all
    before the build; the BPTT wrappers count the route by name."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the launcher reached the build"))
    m, gates = (lstm_cuda, 4) if cell == "lstm" else (gru_cuda, 3)
    assert "wide_mma_stream" in lstm_cuda.BWD_ROUTES and "wide_mma_stream" in lstm_cuda.FWD_ROUTES
    wrapper = lstm_cuda.bilstm_bwd if cell == "lstm" else gru_cuda.bigru_bwd
    assert "wide_mma_stream" in wrapper.routes
    with pytest.raises(ValueError, match="takes the routes"):
        m.bwd_launch("wide_mma_streamed", *_bwd_inputs(cell, 2, 1, 640, torch.bfloat16))
    with pytest.raises(ValueError, match="takes the routes"):
        m.fwd_launch("wide_mma_streamed", *_bwd_inputs(cell, 2, 1, 640, torch.bfloat16)[:4],
                     *(() if cell == "lstm" else _bwd_inputs(cell, 2, 1, 640, torch.bfloat16)[4:6]))
    with pytest.raises(TypeError, match="bfloat16"):
        m.bwd_launch("wide_mma_stream", *_bwd_inputs(cell, 2, 1, 640, torch.float32))
    past = wm.stream_bwd_max_h(gates) + 32
    with pytest.raises(ValueError, match=f"H <= {wm.stream_bwd_max_h(gates)}, got H={past}"):
        m.bwd_launch("wide_mma_stream", *_bwd_inputs(cell, 2, 1, past, torch.bfloat16))


# --- the layers and the models against JAX ---------------------------------------------


def random_params(jm, x, rng):
    """Parameters of the JAX layer ``jm`` for input ``x`` drawn from ``rng``
    with no initialiser run (the orthogonal init's QR takes most of a wide
    layer's test on the CPU): weights N(0, 1/fan_in), biases (the GRU's
    b_hn included) N(0, 0.01), nonzero so that a misplaced one shows."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x)
    return jax.tree.map(lambda s: jnp.asarray(
        rng.normal(size=s.shape) * (s.shape[0] ** -0.5 if len(s.shape) == 2 else 0.1), s.dtype),
        shapes)


def _grads_against_jax(cell, H, T=16, B=2, D=48, seed=0, drawn=False):
    """(port, JAX) outputs and gradients (x, then every parameter in the
    port's order) of sum(y · dy) for one f32 bidirectional layer with the
    same weights (``drawn``: from :func:`random_params`, else JAX's
    initialisers with nonzero biases); JAX on its scan path
    (``use_pallas=False``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    jm = JaxBiLSTM(H, compute_dtype="float32", cell_type=cell, use_pallas=False)
    if drawn:
        params = random_params(jm, jnp.asarray(x), rng)
    else:
        params = jm.init(jax.random.key(seed), jnp.asarray(x))
        # nonzero biases, the GRU's b_hn included: zeros would hide a misplaced one
        params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype)
                              if a.ndim == 1 else a, params)

    def loss(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * dy), y

    (_, y_j), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = BiLSTM(D, H, compute_dtype="float32", cell_type=cell)
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    by_param = {id(p): v for p, v in weights._converted(tm, jax.tree.map(np.asarray, gp))}
    got = [xt.grad.numpy()] + [p.grad.numpy() for p in tm.parameters()]
    want = [np.asarray(gx)] + [by_param[id(p)] for p in tm.parameters()]
    return y.detach().numpy(), np.asarray(y_j), got, want


@pytest.mark.parametrize(
    "cell,H,T,B",
    [pytest.param(c, h, 16, 2, id=f"{c}-{h}") for c, h in (("lstm", 640), ("gru", 704))]
    + [pytest.param(c, h, 9, 3, id=f"{c}-{h}-T9-B3") for c, h in (("lstm", 640), ("gru", 704))])
def test_stream_width_layers_and_gradients_match_jax_scan(cell, H, T, B):
    """The first widths the streamed kernels take in bf16 (both passes),
    held in f32 (the CPU runs the twins) against the JAX package's scan at
    T = 16, B = 2 and T = 9, B = 3: the outputs within 1e-5, each gradient
    within 1e-4 of its largest |value|."""
    y, y_j, got, want = _grads_against_jax(cell, H, T=T, B=B)
    assert y.shape == (B, T, 2 * H)
    np.testing.assert_allclose(y, y_j, atol=1e-5)
    assert len(got) == len(want) == (7 if cell == "lstm" else 9)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("generator,count", [("cnn_blstm", 13_348_195), ("bgru", 38_840_419)])
def test_blstm_size_2048_parameter_counts_match_jax(generator, count):
    """Config 3 and the BGRU at ``blstm_size=2048`` (H = 1024 a direction;
    label dim 425, 99 features), the models phase 17 serves and trains: the
    shapes JAX would initialise (``jax.eval_shape``, no compute) hold as many
    parameters as the port's model."""
    L = 425
    shapes = jax.eval_shape(
        jax_build_generator(JaxModelConfig(generator=generator, blstm_size=2048),
                            JaxVocoderConfig(), L).init,
        jax.random.key(0), jax.ShapeDtypeStruct((1, 64, L), jnp.float32))
    assert jax_count_params(shapes) == count
    model = build_generator(ModelConfig(generator=generator, blstm_size=2048), VocoderConfig(), L)
    assert count_params(model) == count


# --- the f32 forward's kept rows -------------------------------------------------------


@pytest.mark.parametrize("B,route", [(1, "wide"), (2, "wide"), (3, "wide"), (4, "wide_f32"),
                                     (5, "wide_f32"), (6, "wide_f32")])
def test_f32_wide_forward_keeps_wide_where_the_card_measured_it_faster(B, route):
    """``mma_layout.F32_WIDE_FWD``: the f32 GRU forward at H = 336 stays on
    the CUDA-core cluster kernel up to B = 3, where the card measured it
    1.05–1.10x faster than "wide_f32" in turns, and takes "wide_f32" from
    B = 4, where that measured 1.03–1.11x faster (``python3 chip_smoke.py
    --f32-times``); past H = 336 and in the LSTM at every B, "wide_f32"."""
    assert fwd_route(torch.float32, 336, "gru", B) == route
    assert fwd_route(torch.float32, 352, "gru", B) == "wide_f32"
    assert fwd_route(torch.float32, 336, "lstm", B) == "wide_f32"
    assert bwd_route(torch.float32, 336, "gru") == "wide_f32"
