"""The f32 narrow BPTTs (route ``"narrow_f32"``) on the CPU.

``csrc/{bilstm,bigru}_bwd_narrow_f32.cu`` run on the card only; what
surrounds them is replayed here in torch (``ops/narrow_f32_layout.py``): the
widths the route takes, the split of a direction's units over a cluster and
the packing of ``W_h`` with its padding columns, the plan of blocks, rows,
bytes and waves (held against the launchers' own plan on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the routes the card
measured faster, and a BPTT with its products summed in the kernels' order
against the plain twins, which are held against the Pallas kernels in
interpret mode.

Tolerances: the replayed BPTT within 1e-6·max(1, max|v|) of the twins (f32,
the same math with the products summed in another order over T = 5 steps);
the twins within 1e-5·max(1, max|v|) of the Pallas kernels (f32, XLA's sums
in another order); the packing and the plan exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch.ops import narrow_f32_layout as nf
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import at_width, bilstm_bwd_reference, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

GATES = {"lstm": 4, "gru": 3}
# clusters of U blocks the H100 holds at once (1 block an SM: 512 threads of
# up to 128 registers fill its register file), as the launchers report them
# for U = 1, 2, 4, 7, 8 (chip_smoke.py phase 15a prints them); the other
# sizes, which only a forced split takes, an estimate
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 7: 15, 8: 15,
                 **{u: 132 // u // 2 for u in (3, 5, 6, 9, 10, 11, 12, 13, 14, 15, 16)}}


def _inputs(cell, T, B, H, seed):
    """numpy-seeded f32 BPTT inputs of ``cell`` in the twins' order: gx, W_h
    (and b_hn) per direction from a forward pass of the twin, the previous
    states (t−1 forward, t+1 backward) and dy."""
    rng = np.random.default_rng(seed)
    gates = GATES[cell]
    a = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    gx = [a(T, B, gates * H), a(T, B, gates * H)]
    wh = [a(H, gates * H, sc=H ** -0.5), a(H, gates * H, sc=H ** -0.5)]
    dy = [a(T, B, H), a(T, B, H)]
    z = torch.zeros(1, B, H)
    if cell == "lstm":
        yf, yb, cf, cb = bilstm_fwd_reference(*gx, *wh, with_cells=True)
        return (*gx, *wh, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
                torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, *dy)
    bn = [a(H, sc=0.1), a(H, sc=0.1)]
    yf, yb = bigru_fwd_reference(*gx, *wh, *bn)
    return (*gx, *wh, *bn, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), *dy)


def _close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


# --- the sums against the twins and the Pallas kernels ----------------------------


@pytest.mark.parametrize("cell,H,blocks", [
    ("lstm", 64, 2), ("lstm", 96, 4), ("lstm", 128, 4), ("lstm", 160, 8), ("lstm", 256, 8),
    ("gru", 64, 1), ("gru", 128, 2), ("gru", 224, 4), ("gru", 320, 16),
])
def test_replayed_bptt_matches_the_twins(cell, H, blocks):
    """The BPTT summed in the kernels' order (``replay_bptt``: each block's
    recompute and dh partials over four lanes, the partials added in block
    order; LSTM H = 160 over 7 blocks of 24 units and GRU H = 320 over 14,
    their last blocks short, GRU H = 224 over 4 of 56 units, 168 columns
    padded to 192) within 1e-6 of the twins."""
    s = nf.split(H, blocks, GATES[cell])
    assert s.U <= blocks and (s.U - 1) * s.Hb < H <= s.U * s.Hb
    args = _inputs(cell, 5, 3, H, seed=H)
    twin = bilstm_bwd_reference if cell == "lstm" else bigru_bwd_reference
    _close(nf.replay_bptt(cell, *args, blocks=blocks), twin(*args), 1e-6)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_twin_matches_the_pallas_kernel_at_h128(cell):
    """The twins the kernels are held against on the card equal
    ``_bilstm_bwd_pallas`` / ``_bigru_bwd_pallas`` in interpret mode at f32
    H = 128 (T = 9, B = 3) on the same numpy-seeded inputs."""
    args = _inputs(cell, 9, 3, 128, seed=9)
    if cell == "lstm":
        want = lstm_pallas._bilstm_bwd_pallas(*(jnp.asarray(a.numpy()) for a in args),
                                              interpret=True)
        got = bilstm_bwd_reference(*args)
    else:
        want = lstm_pallas._bigru_bwd_pallas(*(jnp.asarray(a.numpy()) for a in args),
                                             interpret=True)
        got = bigru_bwd_reference(*args)
    _close(got, want, 1e-5)


# --- the split and the packing ----------------------------------------------------------


@pytest.mark.parametrize("cell,H,blocks", [
    ("lstm", 8, 1), ("lstm", 128, 2), ("lstm", 160, 8), ("lstm", 256, 16),
    ("gru", 64, 4), ("gru", 224, 4), ("gru", 320, 8), ("gru", 320, 16),
])
def test_packing_round_trip(cell, H, blocks):
    """``pack_wh`` gives every column of W_h once, each block's gates of its
    own units, zero past the last unit and in the padding to NCP (a multiple
    of 32), and unpacks to W_h exactly."""
    gates = GATES[cell]
    s = nf.split(H, blocks, gates)
    assert s.Hb % nf.K_GRANULE == 0 and s.NC == gates * s.Hb and s.NCP % nf.COLS == 0
    assert s.NC <= s.NCP < s.NC + nf.COLS
    wh = torch.randn(H, gates * H, generator=torch.Generator().manual_seed(H))
    wp = nf.pack_wh(wh, s)
    assert wp.shape == (s.U, H, s.NCP) and wp.is_contiguous()
    cols = nf.columns(H, s)
    assert torch.equal(cols[cols >= 0].sort().values, torch.arange(gates * H))
    for b in range(s.U):
        units = cols[b][cols[b] >= 0] % H
        assert ((units >= b * s.Hb) & (units < (b + 1) * s.Hb)).all()
    assert (wp.permute(0, 2, 1)[cols < 0] == 0).all()
    assert torch.equal(nf.unpack_wh(wp, s), wh)
    with pytest.raises(ValueError, match="not a split"):
        nf.pack_wh(wh, nf.split(H, blocks, 7 - gates))  # the other cell's split


# --- the plan ------------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_plan_fits_at_the_path_batches(cell, B):
    """At H = 128 and the route's widest H, B = 1, 8, 32, 160 on the H100's
    clusters: a plan whose block (the W_h slice, h_prev, z, dz, the slots and
    the GRU's dn_pre, as ``smem_bytes`` counts them) fits 232,448 bytes, at most 2 (row, unit)
    pairs a thread, and the fewest waves any candidate gives."""
    gates = GATES[cell]
    for H in (128, nf.MAX_H[gates]):
        p = nf.plan(B, H, gates, H100_CLUSTERS)
        s = nf.Split(*p[:4])
        ws = s.NCP + 4
        parts = {"w": H * ws, "h": 2 * p.R * H, "z": p.R * ws, "dz": p.R * ws,
                 "slots": 2 * s.U * p.R * s.Hb, "dn_pre": (gates == 3) * p.R * s.Hb}
        assert p.smem == 4 * sum(parts.values()) == nf.smem_bytes(H, s, p.R) <= nf.SMEM_OPTIN
        assert p.R * s.Hb <= nf.MAX_PAIRS * nf.THREADS and p.R in nf.ROWS
        assert p.clusters == H100_CLUSTERS[s.U]
        assert p.waves == -(-2 * -(-B // p.R) // p.clusters)
        fewest = min(-(-2 * -(-B // R) // H100_CLUSTERS[c.U])
                     for c, R, _ in nf.candidates(H, gates))
        assert p.waves <= max(fewest, 1) + 1


def test_plan_takes_the_least_estimate_and_its_overrides():
    """The plan is the candidate of least ``waves × step_cost``, the first on
    a tie; ``blocks`` and ``rows`` restrict the candidates as the launchers'
    overrides do, and a forced split that fits nothing raises."""
    for B in (1, 2, 4, 8, 16, 32, 160):
        for H, gates in ((64, 4), (128, 4), (256, 4), (128, 3), (320, 3)):
            p = nf.plan(B, H, gates, H100_CLUSTERS)
            costs = [-(-2 * -(-B // R) // H100_CLUSTERS[s.U]) * nf.step_cost(H, s, R)
                     for s, R, _ in nf.candidates(H, gates)]
            assert min(costs) == -(-2 * -(-B // p.R) // p.clusters) * nf.step_cost(
                H, nf.Split(*p[:4]), p.R)
            forced = nf.plan(B, H, gates, H100_CLUSTERS, blocks=p.U, rows=p.R)
            assert forced[:5] == p[:5]
    assert nf.plan(8, 128, 4, H100_CLUSTERS, rows=16).R == 16
    assert nf.plan(8, 128, 4, H100_CLUSTERS, blocks=8).U == 8
    with pytest.raises(ValueError, match="no f32 narrow BPTT plan"):
        nf.plan(8, 256, 4, H100_CLUSTERS, blocks=1)  # 1 MiB of W_h in one block


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_width_the_route_takes_has_a_plan(cell):
    """f32 up to the one-block kernels' widest H (LSTM 256, GRU 320): every
    width pads to a multiple of 8 and has a plan at B = 1 and 160 on the
    H100; the BPTT takes ``"narrow_f32"`` there without a batch, the
    forward too; past it the cluster routes."""
    gates = GATES[cell]
    top = nf.MAX_H[gates]
    for H in range(1, top + 1):
        Hp = nf.padded(H)
        assert Hp % 8 == 0 and Hp - H < 8 and nf.fits(H, gates)
        for B in (1, 160):
            assert nf.plan(B, Hp, gates, H100_CLUSTERS).smem <= nf.SMEM_OPTIN
        assert bwd_route(torch.float32, H, cell) == "narrow_f32"
        assert fwd_route(torch.float32, H, cell) == "narrow_f32"
    assert not nf.fits(top + 1, gates) and not nf.fits(0, gates)
    assert bwd_route(torch.float32, top + 1, cell) in ("wide", "wide_f32")
    for H in (16, 100, 128):  # bf16 is not this route's
        assert bwd_route(torch.bfloat16, H, cell) in ("mma", "simt")


# the f32 BPTTs timed in turns on the H100 (python3 chip_smoke.py
# --f32-times, T = 512): at each width, the largest B at which the one-block
# kernel ("simt") was faster than "narrow_f32" (0: at none)
MEASURED_B = (1, 2, 4, 8, 16, 32, 160)
SIMT_FASTER_UP_TO = {"lstm": {64: 0, 96: 0, 128: 0, 160: 0, 192: 0, 256: 0},
                     "gru": {64: 0, 128: 0, 192: 0, 256: 0, 320: 0}}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_f32_bptt_route_takes_the_kernel_measured_faster(cell):
    """At every width and batch the card timed, the f32 BPTT's route is the
    faster of the one-block kernel and ``"narrow_f32"``."""
    for H, up_to in SIMT_FASTER_UP_TO[cell].items():
        for B in MEASURED_B:
            want = "simt" if B <= up_to else "narrow_f32"
            assert bwd_route(torch.float32, H, cell) == want, (H, B)


def test_padding_is_exact_through_the_replay():
    """A width the kernels do not take (LSTM H = 100) run zero-padded to 104
    through the replay equals the twin at 100 (``at_width``)."""
    args = _inputs("lstm", 4, 2, 100, seed=5)
    got = at_width(lambda *a: nf.replay_bptt("lstm", *a, blocks=4), nf.padded(100), 4, *args)
    _close(got, bilstm_bwd_reference(*args), 1e-6)
