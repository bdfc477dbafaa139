"""The streamed tensor-core cluster forwards (route ``"wide_mma_stream"``), on the CPU.

Past H = 608 (LSTM) / 672 (GRU) a block's ``W_hᵀ`` slice no longer fits its
shared memory, and ``csrc/bilstm_fwd_wide_mma_stream.cu`` /
``csrc/bigru_fwd_wide_mma_stream.cu`` stream it from L2 in chunks of 64 k,
reading the streamed BPTT's tiles (``ops/wide_mma_layout.py``:
``stream_fwd_plan``, ``stream_fwd_pairs``, ``pack_wh_stream``,
``replay_stream_fwd``). Here: the plan at every width the route takes and
the batches the models run (rows, pairs a compute warp, resident and
streamed chunks, waves, shared memory within the H100's 227 KB); the
compute warps' map of (unit group, 8-row tile) pairs; the product through
the chunk tiles against "wide_mma"'s ``replay_recompute`` (bit for bit);
the whole forward summed in the kernels' order against the twins (f32
within 1e-6 of max(1, max|v|), bf16 within ``KERNEL_TOL``'s 2e-2) and
against the Pallas kernels in interpret mode (f32 within 1e-5); the
routes, ``BF16_WIDE_FWD`` included; the launchers' refusals; the one
packing both passes read. The f32 layers at the route's first widths
against JAX's scan, forward and gradients, are in
``tests/test_torch_wide_mma_stream.py``. The kernels themselves are held
against the twins on the card (``chip_smoke.py`` phase 17,
``tests/test_torch_cuda.py -k wide_mma_stream``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, mma_layout, wide_layout
from percivaltts_tpu_torch.ops import wide_mma_layout as wm
from percivaltts_tpu_torch.ops.gru_cuda import bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

G_OF = {"lstm": 4, "gru": 3}
FIRST = {4: 640, 3: 704}  # the first widths past "wide_mma"'s (multiples of 32 and 64)
CLUSTERS = 7  # clusters of 12–16 blocks the H100 holds at once (chip_smoke.py phases 13–17)
BF16_TOL = 2e-2  # chip_smoke.py's KERNEL_TOL[bf16], of max(1, max|twin|)
COMPUTE_WARPS = wm.STREAM_WARPS - 1


# --- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3, 8, 32, 160])
@pytest.mark.parametrize("gates", [4, 3])
def test_stream_fwd_plan_at_every_width(gates, B):
    """From the first width past "wide_mma" to the route's limit in steps of
    32: R a multiple of 8 up to 64 whose (unit group, 8-row tile) pairs fall
    at most ``STREAM_FWD_MAX_PPW`` to each of the 15 compute warps (and at
    most one tile's worth more than a warp's group holds: PPW <= R / 8),
    two h buffers where they fit beside the ring of ``RING`` slots, the
    room's other chunk slots resident, every chunk resident or streamed (at least
    one streamed), no further slot fitting, the shared memory within
    ``SMEM_OPTIN``, the waves of 2·ceil(B / R) clusters over the card's, and
    the plan no worse by its step estimate than any other R."""
    for H in range(FIRST[gates], wm.stream_max_h(gates) + 1, 32):
        p = wm.plan(H, gates)
        s = wm.stream_fwd_plan(B, H, gates, CLUSTERS)
        assert tuple(s[:3]) == tuple(p)
        nug, nt8 = p.Hb // wm.UNIT_GROUP[gates], s.R // 8
        assert s.R % 8 == 0 and s.R <= wm.STREAM_FWD_MAX_ROWS
        assert s.PPW == -(-nug * nt8 // COMPUTE_WARPS) <= min(nt8, wm.STREAM_FWD_MAX_PPW[gates])
        assert s.nres + s.nstr == wm.chunks(H) and s.nstr >= 1
        assert s.smem == wm.stream_fwd_smem_bytes(H, gates, s.R, s.nres, 1 + s.dbuf) <= wm.SMEM_OPTIN
        assert s.dbuf == (wm.stream_fwd_smem_bytes(H, gates, s.R, 0, 2) <= wm.SMEM_OPTIN)
        if s.nstr > 1:
            assert wm.stream_fwd_smem_bytes(H, gates, s.R, s.nres + 1, 1 + s.dbuf) > wm.SMEM_OPTIN
        assert s.waves == -(-2 * -(-B // s.R) // CLUSTERS)
        assert wm.stream_fwd_plan(B, H, gates, lambda smem: CLUSTERS if smem else 0) == s
        cost = s.waves * wm.stream_fwd_step_ps(H, p.NC, s.R, s.nstr, s.dbuf)
        for R in range(8, wm.STREAM_FWD_MAX_ROWS + 1, 8):
            if (wm.stream_fwd_ppw(H, gates, R) > wm.STREAM_FWD_MAX_PPW[gates]
                    or wm.stream_fwd_smem_bytes(H, gates, R, 0) > wm.SMEM_OPTIN):
                continue
            other = wm.stream_fwd_plan(B, H, gates, CLUSTERS, rows=R)
            assert other.R == R
            assert cost <= other.waves * wm.stream_fwd_step_ps(H, p.NC, R, other.nstr, other.dbuf)


@pytest.mark.parametrize("gates", [4, 3])
def test_stream_fwd_plan_takes_every_width_of_the_route(gates):
    """The forward's plan fits wherever the streamed BPTT's does (the route
    takes both passes to ``stream_max_h``, one rule), and B = 160 at the
    models' H = 1024 runs in one wave of R = 56 (3 tiles a direction, 6
    clusters of 16): the BPTT's slots cap it at 16 / 24 rows. A forced R
    past what fits raises naming the cell."""
    for H in range(FIRST[gates], wm.stream_max_h(gates) + 1, 32):
        assert wm.stream_fits(H, gates)
        assert wm.stream_fwd_plan(8, H, gates, CLUSTERS).R == 8
    s = wm.stream_fwd_plan(160, 1024, gates, CLUSTERS)
    assert (s.R, s.waves, s.dbuf) == (56, 1, 0) and s.nstr >= 15
    assert wm.stream_fwd_smem_bytes(1024, gates, 64, 0) > wm.SMEM_OPTIN or gates == 3
    with pytest.raises(ValueError, match=f"streamed tensor-core wide {wide_layout.CELLS[gates]} "
                                         "forward"):
        wm.stream_fwd_plan(8, wm.stream_max_h(gates), gates, CLUSTERS, rows=64)


@pytest.mark.parametrize("gates", [4, 3])
def test_the_compute_warps_take_every_pair_once(gates):
    """At every width and R the plan weighs, the 15 compute warps take the
    block's (unit group, 8-row tile) pairs PPW at a time, each pair once:
    a warp's pairs are consecutive tiles of one unit group, or of two
    consecutive groups (its run crosses one group's end at most), as the
    kernels' ``ug_of`` / ``tile_of`` address them."""
    for H in range(FIRST[gates], wm.stream_max_h(gates) + 1, 64):
        nug = wm.plan(H, gates).Hb // wm.UNIT_GROUP[gates]
        for R in range(8, wm.STREAM_FWD_MAX_ROWS + 1, 8):
            ppw, nt8 = wm.stream_fwd_ppw(H, gates, R), R // 8
            if ppw > wm.STREAM_FWD_MAX_PPW[gates]:
                continue
            taken = []
            for w in range(COMPUTE_WARPS):
                pairs = wm.stream_fwd_pairs(H, gates, R, w)
                assert len(pairs) <= ppw
                if not pairs:
                    continue
                ug0, t0 = pairs[0]
                na = min(len(pairs), nt8 - t0)
                for i, pair in enumerate(pairs):  # the kernels' ug_of(i), tile_of(i)
                    assert pair == ((ug0, t0 + i) if i < na else (ug0 + 1, i - na))
                taken += pairs
            assert sorted(taken) == [(u, t) for u in range(nug) for t in range(nt8)]


def test_stream_fwd_shared_memory_layout():
    """A block's regions in the kernels' order start where the kernels put
    them: the ring and the resident chunks on 128-byte boundaries (the
    swizzle's bank groups), the h buffers and the staging tiles on 16 (the
    exchange's 16-byte stores), the mbarriers on 8; the staging tiles hold
    PPW pairs × 8 rows × a unit group's bf16 units for each compute warp."""
    for gates in (4, 3):
        for H in (FIRST[gates], 1024, wm.stream_max_h(gates)):
            p = wm.plan(H, gates)
            for B in (1, 32, 160):
                s = wm.stream_fwd_plan(B, H, gates, CLUSTERS)
                h0 = (wm.RING + s.nres) * wm.tile_bytes(p.NC)
                stage0 = h0 + (1 + s.dbuf) * wm._a16(s.R * (H + 8) * 2)
                bar0 = stage0 + COMPUTE_WARPS * s.PPW * 8 * wm.UNIT_GROUP[gates] * 2
                assert wm.tile_bytes(p.NC) % 128 == 0 and h0 % 128 == 0
                assert stage0 % 16 == 0 and bar0 % 8 == 0
                assert bar0 + 2 * wm.RING * 8 == s.smem


# --- the sums -----------------------------------------------------------------------


def _inputs(cell, T, B, H, seed, dtype=torch.float32):
    """numpy-seeded forward inputs of ``cell`` in the twins' order: gx,
    W_h (and b_hn) per direction, in ``dtype``."""
    rng = np.random.default_rng(seed)
    gates = G_OF[cell]
    def a(*s, sc=1.0):
        return torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).to(dtype)
    args = (a(T, B, gates * H), a(T, B, gates * H), a(H, gates * H, sc=H ** -0.5),
            a(H, gates * H, sc=H ** -0.5))
    return args if cell == "lstm" else (*args, a(H, sc=0.1), a(H, sc=0.1))


def _replayed(cell, *args, dtype=torch.float32, split=False):
    """Both directions of the forward summed in the streamed kernels' order
    (``replay_stream_fwd`` on ``pack_wh_stream``'s tiles; ``split``: a plan
    of one pair a warp), in the twins' output order; inputs as f32 values."""
    gates = G_OF[cell]
    args = [a.float() for a in args]
    p = wm.plan(args[2].shape[0], gates)
    dirs = [wm.replay_stream_fwd(args[d], wm.pack_wh_stream(args[2 + d], p), p,
                                 bn=args[4 + d] if cell == "gru" else None, reverse=d == 1,
                                 dtype=dtype, split=split) for d in (0, 1)]
    if cell == "lstm":
        return dirs[0][0], dirs[1][0], dirs[0][1], dirs[1][1]
    return tuple(dirs)


def _twin(cell, *args):
    if cell == "lstm":
        return bilstm_fwd_reference(*args, with_cells=True)
    return bigru_fwd_reference(*args)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.float() if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w, np.float32))
        assert g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("gates,H", [(4, 640), (4, 1056), (3, 704), (3, 1056)])
def test_chunked_product_equals_wide_mma_replay(gates, H):
    """A step's product through the chunk tiles in the kernels' order
    (``replay_stream_recompute``) equals "wide_mma"'s ``replay_recompute`` on
    ``pack_wh``'s slices bit for bit in f32: the same 16-wide k-steps in the
    same order (H = 1056: the last chunk half)."""
    rng = np.random.default_rng(H + gates)
    wh = torch.from_numpy(rng.normal(size=(H, gates * H)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(9, H)).astype(np.float32))
    p = wm.plan(H, gates)
    got = wm.replay_stream_recompute(h, wm.pack_wh_stream(wh, p), p)
    assert torch.equal(got, wm.replay_recompute(h, wm.pack_wh(wh, p), p))
    # one pair a warp: the odd k-steps summed apart, then added
    split = wm.replay_stream_recompute(h, wm.pack_wh_stream(wh, p), p, split=True)
    assert not torch.equal(split, got)
    assert (split - got).abs().max().item() <= 1e-5 * max(1.0, got.abs().max().item())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell,T,B,H", [("lstm", 6, 3, 640), ("lstm", 4, 9, 1024),
                                        ("gru", 6, 3, 704), ("gru", 4, 9, 1024)])
def test_replayed_stream_forward_equals_the_twin(cell, T, B, H, dtype, split):
    """The forward summed in the streamed kernels' order (``split``: a plan
    of one pair a warp, its even and odd k-steps apart) against the twin:
    in f32 within 1e-6 of max(1, max|v|) (the LSTM's cells too); with bf16
    inputs, h rounded to bf16 before each product and the outputs as the
    kernels store them, within ``KERNEL_TOL[bf16]`` of the twin run in bf16."""
    args = _inputs(cell, T, B, H, seed=T + B + H, dtype=dtype)
    got = _replayed(cell, *args, dtype=dtype, split=split)
    want = _twin(cell, *args)
    _close(got, want, 1e-6 if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("cell,H", [("lstm", 640), ("gru", 768)])
def test_replayed_stream_forward_matches_the_pallas_kernel(cell, H):
    """The replayed forward at f32 H = 640 (LSTM) / 768 (GRU: the Pallas GRU
    takes 3H a multiple of 128), T = 4, B = 9, equals ``_bilstm_fwd_pallas``
    / ``_bigru_fwd_pallas`` in interpret mode on the same numpy-seeded
    inputs within 1e-5 of max(1, max|v|), the LSTM's cells too."""
    args = _inputs(cell, 4, 9, H, seed=11)
    pallas = lstm_pallas._bilstm_fwd_pallas if cell == "lstm" else lstm_pallas._bigru_fwd_pallas
    want = pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True)
    _close(_replayed(cell, *args), want, 1e-5)


# --- routes and launchers -----------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_forward_routes_past_the_tensor_core_widths(cell):
    """bf16 forwards: "wide_mma" up to ``max_h`` (608 / 672), then
    "wide_mma_stream" up to ``stream_max_h`` (1536 / 1792), as the BPTT,
    at every B ``BF16_WIDE_FWD`` does not keep on "wide" (where the card
    measured the CUDA-core forward faster), then "wide" (the BPTT there its
    streamed deep layout up to 4096); without B a large batch's route; f32
    keeps its routes."""
    bf16, gates = torch.bfloat16, G_OF[cell]
    first, last = wm.max_h(gates), wm.stream_max_h(gates)
    assert fwd_route(bf16, first, cell) == "wide_mma"
    for H in (first + 1, FIRST[gates], 1000, 1024, last):
        assert fwd_route(bf16, H, cell) == bwd_route(bf16, H, cell) == "wide_mma_stream"
        for B in (1, 2, 3, 4, 8, 32, 160):
            kept = any(H <= h and B <= b for h, b in mma_layout.BF16_WIDE_FWD[cell])
            assert fwd_route(bf16, H, cell, B) == ("wide" if kept else "wide_mma_stream")
    for H in (last + 1, 2048, wide_layout.MAX_H):
        deep = H <= wm.stream_bwd_max_h(gates)
        assert (fwd_route(bf16, H, cell), bwd_route(bf16, H, cell)) == \
            ("wide", "wide_mma_stream" if deep else "wide")
        assert fwd_route(bf16, H, cell, 8) == "wide"
    assert fwd_route(torch.float32, 1024, cell) == "wide"
    assert fwd_route(torch.float32, 512, cell) == "wide_f32"


def test_bf16_wide_fwd_table_is_the_measured_one():
    """``mma_layout.BF16_WIDE_FWD``: the rows where the card measured the
    CUDA-core cluster forward faster than the streamed one in turns
    (``python3 chip_smoke.py --bf16-wide-times``, PERF.md): the LSTM's
    H = 640 up to B = 6; each row's width lies on the streamed route and its
    B within the batches timed. The LSTM forward at H 609–640 takes "wide"
    up to 6 rows and streams from 7, the GRU's streams at every B."""
    assert mma_layout.BF16_WIDE_FWD == {"lstm": ((640, 6),), "gru": ()}
    for B in range(1, 9):
        assert fwd_route(torch.bfloat16, 640, "lstm", B) == ("wide" if B <= 6 else
                                                             "wide_mma_stream")
        assert fwd_route(torch.bfloat16, 624, "lstm", B) == fwd_route(torch.bfloat16, 640,
                                                                      "lstm", B)
        assert fwd_route(torch.bfloat16, 672, "lstm", B) == "wide_mma_stream"
        assert fwd_route(torch.bfloat16, 704, "gru", B) == "wide_mma_stream"
    for cell, rows in mma_layout.BF16_WIDE_FWD.items():
        for h, b in rows:
            assert wm.max_h(G_OF[cell]) < h <= wm.stream_max_h(G_OF[cell]) and 1 <= b <= 160


def _fwd_inputs(cell, T, B, H, dtype):
    gates = G_OF[cell]
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    args = (z(T, B, gates * H), z(T, B, gates * H), z(H, gates * H), z(H, gates * H))
    return args if cell == "lstm" else (*args, z(H), z(H))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forward_launchers_refuse_what_the_stream_route_does_not_take(monkeypatch, cell):
    """The forward launchers take "wide_mma_stream" (``FWD_ROUTES`` is
    ``BWD_ROUTES``) and count it by name; the streamed forward refuses f32
    (``TypeError``) and a width past ``stream_max_h`` (``ValueError`` naming
    it), both before the build."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the launcher reached the build"))
    m, gates = (lstm_cuda, 4) if cell == "lstm" else (gru_cuda, 3)
    assert "wide_mma_stream" in lstm_cuda.FWD_ROUTES
    wrapper = lstm_cuda.bilstm_fwd if cell == "lstm" else gru_cuda.bigru_fwd
    assert "wide_mma_stream" in wrapper.routes
    with pytest.raises(TypeError, match="streamed tensor-core wide forwards take bfloat16"):
        m.fwd_launch("wide_mma_stream", *_fwd_inputs(cell, 2, 1, 640, torch.float32))
    past = wm.stream_max_h(gates) + 32
    with pytest.raises(ValueError, match=f"forwards take H <= {wm.stream_max_h(gates)}, "
                                         f"got H={past}"):
        m.fwd_launch("wide_mma_stream", *_fwd_inputs(cell, 2, 1, past, torch.bfloat16))


class _FakeLibrary:
    """Records each launcher call's arguments (pointers as ints) and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_both_passes_launch_one_packing(monkeypatch, cell):
    """For the same ``W_h`` the streamed forward's launcher and the streamed
    BPTT's build the identical packed tensor (``pack_wh_stream``'s 64-k chunk
    tiles, through ``lstm_cuda.stream_args``) and hand the kernels its
    memory: at the widths both passes stream, one packing for both, which a
    ``W_h``-packing cache may share (past them the BPTT's deep layout packs
    its own 32-k tiles). The card is faked (the launch records its
    arguments; the BPTT's plan is the layout's at 7 clusters)."""
    packs = []
    real = wm.pack_wh_stream

    def recording(wh, p, chunk=wm.CHUNK):
        out = real(wh, p, chunk)
        packs.append(out)
        return out

    def plan(kind, B, H, device=0):
        return wm.stream_plan(B, H, 4 if kind == "bilstm" else 3, 7)

    lib = _FakeLibrary()
    monkeypatch.setattr(wm, "pack_wh_stream", recording)
    monkeypatch.setattr(lstm_cuda, "stream_plan", plan)
    monkeypatch.setattr(gru_cuda, "stream_plan", plan)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    H, T, B = FIRST[G_OF[cell]], 3, 2
    m = lstm_cuda if cell == "lstm" else gru_cuda
    name = "bilstm" if cell == "lstm" else "bigru"
    args = _inputs(cell, T, B, H, seed=5, dtype=torch.bfloat16)
    m.fwd_launch("wide_mma_stream", *args)
    fwd = lib.calls[f"percival_{name}_fwd_wide_mma_stream"]
    states = [torch.zeros(T, B, H, dtype=torch.bfloat16) for _ in range(8 if cell == "lstm" else 4)]
    m.bwd_launch("wide_mma_stream", *args, *states)
    bwd = lib.calls[f"percival_{name}_bwd_wide_mma_stream"]
    assert len(packs) == 4
    for d in (0, 1):  # each direction: the forward's pack, then the BPTT's
        assert torch.equal(packs[d], packs[2 + d])
        assert fwd[2 + d] == packs[d].data_ptr() and bwd[2 + d] == packs[2 + d].data_ptr()
    p = wm.plan(H, G_OF[cell])
    assert packs[0].shape == (p.U, wm.chunks(H), p.NC, wm.CHUNK)


@pytest.mark.parametrize("cell,H", [("lstm", 1024), ("gru", 1024), ("lstm", 640)])
def test_registered_operators_launch_the_streamed_forward(monkeypatch, cell, H):
    """The CUDA kernels of ``percival::bilstm_fwd`` / ``percival::bigru_fwd``
    (what an exported graph calls) choose their route by ``fwd_route`` with
    the call's rows: bf16 at H = 1024 launches "wide_mma_stream" at B = 8;
    the LSTM at H = 640 with B = 2 takes ``BF16_WIDE_FWD``'s "wide". The
    launch is faked (it records its route) and counted once on it; the
    wrapper's counters are restored after (other tests read them)."""
    launched = []
    m = lstm_cuda if cell == "lstm" else gru_cuda
    monkeypatch.setattr(m, "fwd_launch", lambda route, *a, **kw: launched.append(route) or ())
    B = 2 if H == 640 else 8
    args = _inputs(cell, 2, B, H, seed=3, dtype=torch.bfloat16)
    wrapper = lstm_cuda.bilstm_fwd if cell == "lstm" else gru_cuda.bigru_fwd
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    monkeypatch.setattr(wrapper, "routes", dict(wrapper.routes))
    before = dict(wrapper.routes)
    if cell == "lstm":
        lstm_cuda._bilstm_fwd_cuda(*args, with_cells=False)
    else:
        gru_cuda._bigru_fwd_cuda(*args)
    want = "wide" if H == 640 else "wide_mma_stream"
    assert launched == [want]
    assert wrapper.routes[want] == before[want] + 1
