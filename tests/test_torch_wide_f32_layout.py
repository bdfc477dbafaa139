"""The f32 cluster BPTTs (route ``"wide_f32"``) on the CPU, without jax.

``csrc/{bilstm,bigru}_bwd_wide_f32.cu`` run on the card only; what
surrounds them is replayed here in torch (``ops/wide_f32_layout.py``): the
widths the route takes, the rows a cluster and the shared memory each plan
takes (``rows``, held against the launchers' own plan on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the per-block packing of
``W_h`` the kernels stream in chunks, the shared-memory strides that keep
both products' loads free of bank conflicts, and a BPTT with its products
summed in the kernels' order against the plain twins.

Tolerances: the replayed BPTT within 1e-5 of the twins (f32, the same math
with the products summed in another order over T = 5 steps); the packing
exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import inspect

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops import wide_f32_layout as wf
from percivaltts_tpu_torch.ops import wide_layout
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import at_width, bilstm_bwd_reference, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

H100_CLUSTERS = 7  # clusters of 16 blocks the H100 holds at once (chip_smoke.py phase 13)


# --- the plan ---------------------------------------------------------------


def _parts(H, gates, R, nres):
    """The byte count of each region of a block's shared memory."""
    p = wide_layout.plan(H, gates)
    slot = wf.CHUNK * (p.NC + 4) * 4
    nch = len(wf.chunks(H))
    return {"ring": (wf.RING if nres < nch else 0) * slot, "resident": nres * slot,
            "h_prev": R * H * 4, "dz": R * (p.NC + 8) * 4, "z": R * (p.NC + 8) * 4,
            "slots": p.U * p.Hb * R * 4}


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("B,R,waves", [(1, 8, 1), (8, 8, 1), (32, 16, 1), (160, 24, 2)])
def test_rows_and_bytes_at_h512(gates, B, R, waves):
    """At H = 512 on the H100's 7 clusters: B <= 32 in one wave, B = 160 in
    two of 24 rows (one wave would need R >= 54); each region of shared
    memory, the resident chunks as many as fit, within 232,448 bytes."""
    r = wf.rows(B, 512, gates, H100_CLUSTERS)
    assert (r.R, r.waves) == (R, waves)
    parts = _parts(512, gates, r.R, r.nres)
    assert sum(parts.values()) == r.smem == wf.smem_bytes(512, gates, r.R, r.nres)
    assert r.smem <= wf.SMEM_OPTIN
    assert r.nres + r.nstr == len(wf.chunks(512)) == 8 and r.nstr >= 1
    assert wf.smem_bytes(512, gates, r.R, r.nres + 1) > wf.SMEM_OPTIN


@pytest.mark.parametrize("gates", [4, 3])
def test_every_width_the_route_takes_has_a_plan(gates):
    """f32 past the one-block kernels (LSTM 256, GRU 320) up to 512: every
    width pads to a multiple of 32, splits into at most 128 gate columns a
    block, keeps three or more chunks and fits B = 160 in shared memory;
    past 512 the route is the CUDA-core cluster kernel's."""
    low = 256 if gates == 4 else 320
    cell = "lstm" if gates == 4 else "gru"
    assert wf.max_h(gates) == 512
    for H in range(low + 1, 513):
        Hp = wf.padded(H)
        p = wide_layout.plan(Hp, gates)
        assert wf.fits(H, gates) and p.NC <= wf.MAX_NC and len(wf.chunks(Hp)) >= 3
        r = wf.rows(160, Hp, gates, H100_CLUSTERS)
        assert r.smem <= wf.SMEM_OPTIN and r.nres + r.nstr == len(wf.chunks(Hp))
        assert bwd_route(torch.float32, H, cell) == "wide_f32"
        assert fwd_route(torch.float32, H, cell) == "wide_f32"
    for H in (513, 544, 608, 640, 1024, 4096):
        assert not wf.fits(H, gates)
        assert bwd_route(torch.float32, H, cell) == fwd_route(torch.float32, H, cell) == "wide"
    assert not wf.fits(128, gates) and wf.fits(129, gates)


# the f32 cluster BPTTs timed in turns on the H100 (python3 chip_smoke.py
# --f32-times, T = 512, B in MEASURED_B): at each width, the largest B at
# which the CUDA-core cluster kernel ("wide") was faster than "wide_f32"
# (0: at none); "wide_f32" was faster at every larger B. Since "wide_f32"
# takes its few-row kernels at B <= 8, "wide" is faster nowhere
MEASURED_B = (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 160)
WIDE_FASTER_UP_TO = {"lstm": {264: 0, 288: 0, 320: 0, 384: 0, 416: 0, 448: 0, 512: 0},
                     "gru": {336: 0, 352: 0, 384: 0, 416: 0, 448: 0, 512: 0}}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_f32_bptt_route_takes_the_kernel_measured_faster(cell):
    """At every width and batch the card timed, the f32 BPTT's route is the
    faster of the two cluster kernels: ``"wide_f32"`` (at B <= 8 its plan
    takes the few-row kernels wherever one fits, the LSTM up to H = 416);
    the forward takes ``"wide_f32"`` at every batch; the f32 BPTT's route
    is the same at every batch (only the bf16 table ``BF16_WIDE_BWD`` reads
    one)."""
    gates = 4 if cell == "lstm" else 3
    for H, up_to in WIDE_FASTER_UP_TO[cell].items():
        for B in MEASURED_B:
            want = "wide" if B <= up_to else "wide_f32"
            assert bwd_route(torch.float32, H, cell) == want, (H, B)
            assert bwd_route(torch.float32, H, cell, B) == want, (H, B)
            assert fwd_route(torch.float32, H, cell) == "wide_f32"
            few = B <= wf.FEW_MAX_B and wf.few_fits(wf.padded(H), gates, 1)
            assert (wf.bwd_plan(B, wf.padded(H), gates, H100_CLUSTERS).R <= 4) == few, (H, B)
    assert list(inspect.signature(bwd_route).parameters) == ["dtype", "H", "cell", "B"]


def test_chunks_cover_the_slice():
    for H in (160, 288, 320, 352, 512):
        ch = wf.chunks(H)
        assert [k0 for k0, _ in ch] == list(range(0, H, wf.CHUNK))
        assert sum(n for _, n in ch) == H and all(n % 32 == 0 for _, n in ch)


# --- the packing and the swizzle -----------------------------------------------


@pytest.mark.parametrize("H,gates", [(288, 4), (512, 4), (352, 3), (512, 3)])
def test_packing_round_trip(H, gates):
    """``pack_wh`` (the ``"wide"`` route's per-block packing, which the f32
    kernels stream in 64-row chunks) gives every column of W_h once, zero
    past the last unit, and unpacks to W_h exactly."""
    g = torch.Generator().manual_seed(H)
    wh = torch.randn(H, gates * H, generator=g)
    p = wide_layout.plan(H, gates)
    wp = wide_layout.pack_wh(wh, p)
    cols = wide_layout.columns(H, p)
    back = torch.empty_like(wh)
    for b in range(p.U):
        ok = cols[b] >= 0
        back[:, cols[b][ok]] = wp[b][:, ok]
        assert torch.all(wp[b][:, ~ok] == 0)
    assert torch.equal(back, wh)


def _wavefronts(addrs):
    """Shared-memory wavefronts of one quarter-warp's float4 loads (8 word
    addresses, each the first of 4 words): a distinct address more than once
    on a bank group costs another; one address read by several lanes once."""
    groups = {}
    for a in set(addrs):
        for w in range(a, a + 4):
            groups.setdefault(w % 32, set()).add(a)
    return max(len(v) for v in groups.values())


@pytest.mark.parametrize("gates,H", [(4, 512), (3, 512), (4, 288), (3, 352)])
@pytest.mark.parametrize("R", [8, 16, 24])
def test_quarter_warp_loads_are_free_of_bank_conflicts(gates, H, R):
    """A chunk row's stride is NC + 4 words, the dz rows' NC + 8. Each
    quarter-warp (8 lanes) of the recompute reads 8 float4s of one chunk row
    and one broadcast float4 of h_prev; of the dh product, 4 float4s of each
    of two chunk rows 4 apart (16 banks apart) and a broadcast run of 4
    float4s of dz: one wavefront each. The gate phase's warp (8 units × 4
    rows) writes dz and reads z on 32 banks."""
    p = wide_layout.plan(H, gates)
    NC, ws, ds, RH = p.NC, p.NC + 4, p.NC + 8, R // 2
    for x in range(0, 64, 4):  # (a): lanes (j, p), quarter j: row x + i, columns 32co + 4p
        for co in range(NC // 32):
            for i in range(4):
                assert _wavefronts([(x + i) * ws + 32 * co + 4 * pp for pp in range(8)]) == 1
        for r in range(RH):  # h_prev row r, k x … x+3, the same for the quarter
            assert _wavefronts([r * H + x] * 8) == 1
    for kg in range(0, 16, 2):  # (b): quarter = tiles kg, kg + 1 × lanes i = 0..3
        for m in range(0, NC, 16):
            for i in range(4):
                addrs = [(4 * (kg + t) + i) * ws + m + 4 * c for t in range(2) for c in range(4)]
                assert _wavefronts(addrs) == 1
            for r in range(RH):
                assert _wavefronts([r * ds + m + 4 * c for t in range(2) for c in range(4)]) == 1
    for uo in range(p.Hb // 8):  # the gate phase: lanes (u = lane & 7, r = lane >> 3)
        for g in range(gates):
            banks = [(r * ds + g * p.Hb + 8 * uo + u) % 32 for r in range(4) for u in range(8)]
            assert sorted(banks) == list(range(32))


# --- the sums -----------------------------------------------------------------


def _inputs(cell, T, B, H, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    G = 4 if cell == "lstm" else 3
    gx_f, gx_b = t(T, B, G * H), t(T, B, G * H)
    wh_f, wh_b = t(H, G * H, sc=H ** -0.5), t(H, G * H, sc=H ** -0.5)
    z = torch.zeros(1, B, H)
    if cell == "lstm":
        yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
        states = (torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), torch.cat([z, cf[:-1]]),
                  torch.cat([cb[1:], z]), cf, cb, t(T, B, H), t(T, B, H))
    else:
        bn_f, bn_b = t(H), t(H)
        yf, yb = bigru_fwd_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
        states = (bn_f, bn_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), t(T, B, H),
                  t(T, B, H))
    return (gx_f, gx_b, wh_f, wh_b, *states)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [264, 320, 336, 384, 512])
def test_replayed_f32_bptt_equals_the_twin(cell, H):
    """The BPTT with its products summed as the kernels sum them (each
    block's recompute in four k-quad lanes added in pairs, its dh partials
    in four column lanes met in the reduce-scatter's tree, the U block
    partials added in block order by the owner, the GRU's dh·z first), at
    the width the wrapper pads H to (264 → 288, 336 → 352: a short last
    block), equals the twin within 1e-5."""
    args = _inputs(cell, 5, 3, H, seed=H)
    gates = 4 if cell == "lstm" else 3
    twin = bilstm_bwd_reference if cell == "lstm" else bigru_bwd_reference
    want = twin(*args)
    got = at_width(lambda *a: wf.replay_bptt(cell, *a), wf.padded(H), gates, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert (g - w).abs().max().item() <= 1e-5


def test_replay_refuses_widths_the_kernels_do_not_run():
    args = _inputs("lstm", 2, 1, 264, seed=1)
    with pytest.raises(ValueError, match="multiples of 32"):
        wf.replay_bptt("lstm", *args)
