"""The tensor-core wide kernels' split, packing and fragments, on the CPU.

``csrc/bilstm_bwd_wide_mma.cu`` and ``csrc/bigru_bwd_wide_mma.cu`` run a
direction on a cluster of blocks (``ops/wide_mma_layout.py``): block ``b``
holds its ``W_hᵀ`` slice (``pack_wh``: packed rows of the tensor-core
forwards' order) in shared memory, 16 warps share out the (unit group, 8-row
tile) cells of the recompute and the gate math (one a warp), and the 16-unit tiles of the
chained product, whose partials go to the blocks that own the units. The
forwards ``csrc/bilstm_fwd_wide_mma.cu`` and ``csrc/bigru_fwd_wide_mma.cu``
run the recompute's product on the same slice, a warp taking one unit group
and ``TPW`` 8-row tiles, and all-gather ``round(h)`` into every block.

Here the kernels' address arithmetic is replayed in Python (the same
expressions as the sources, lane by lane): every ldmatrix address gives
exactly the ``mma.m16n8k16`` fragment the product needs (PTX ISA layouts),
the accumulators land on the gates and rows the gate phase names, the dz
tile and the partial slots are written where they are read; and a plain
BPTT whose products and exchange run through the packed slices and the
split equals ``bilstm_bwd_reference`` / ``bigru_bwd_reference`` in f32
within 1e-5 of the largest gradient (the kernels sum over K in 16-wide
k-steps and over the blocks in order: the same terms in another order, at
unit scale a few ulps of f32), as does a plain forward stepped through the
packed slices against ``bilstm_fwd_reference`` / ``bigru_fwd_reference``.
The route table, the BPTT's row choice and the forward's (rows, tiles a
warp, h buffers, the warp map and the exchange's 16-byte chunks) are checked
too; the card holds the kernels to the twins (``tests/test_torch_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops import wide_layout, wide_mma_layout as wm
from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import (
    at_width,
    bilstm_bwd_reference,
    bilstm_fwd_reference,
)
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

L = torch.arange(32)  # lanes
G_OF = {"lstm": 4, "gru": 3}
# (cell, T, B, H): H = 264 / 336 (the Pallas-parity widths, padded to 288 /
# 352), 512 (the models' H), 200 (not a multiple of 16); B not a multiple of 8
CASES = [("lstm", 5, 11, 264), ("gru", 5, 11, 336), ("lstm", 3, 13, 512), ("gru", 3, 13, 512),
         ("lstm", 4, 9, 200), ("gru", 4, 9, 200)]


def _ldmatrix(addr, n_mats, trans=False):
    """``(32, n_mats, 2)`` flat shared-memory indices each lane receives from
    ``ldmatrix`` (``.trans``): row ``ρ`` of matrix ``i`` starts at the address
    lane ``8i + ρ`` gives. Plain: lane ``l`` gets row ``l // 4``, elements
    ``2(l % 4)`` and ``+1``; transposed: rows ``2(l % 4)`` and ``+1`` of
    element ``l // 4``."""
    i = torch.arange(n_mats)[None, :, None]
    h = torch.arange(2)[None, :][:, None, :]
    lane = L[:, None, None]
    if trans:
        return addr(8 * i + 2 * (lane % 4) + h) + lane // 4
    return addr(8 * i + lane // 4) + 2 * (lane % 4) + h


def _a_coords(reg):
    """PTX m16n8k16 A fragment: ``(m, k)`` of register ``reg`` (pair h) for each lane."""
    lane, h = L[:, None], torch.arange(2)[None, :]
    return lane // 4 + 8 * (reg % 2) + 0 * h, 8 * (reg // 2) + 2 * (lane % 4) + h


def _b_coords(reg):
    """PTX m16n8k16 B fragment: ``(k, n)`` of register ``reg`` (pair h)."""
    lane, h = L[:, None], torch.arange(2)[None, :]
    return 8 * reg + 2 * (lane % 4) + h, lane // 4 + 0 * h


def _d_coords():
    """PTX m16n8 accumulator: ``(m, n)`` of element ``e`` for each lane, ``(32, 4)``."""
    lane, e = L[:, None], torch.arange(4)[None, :]
    return lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2


def _mma(a_vals, b_vals):
    """``D (16, 8)`` from lane fragments: ``a_vals (32, 4, 2)``, ``b_vals (32, 2, 2)``."""
    A = torch.zeros(16, 16, dtype=a_vals.dtype)
    Bm = torch.zeros(16, 8, dtype=b_vals.dtype)
    for reg in range(4):
        m, k = _a_coords(reg)
        A[m, k] = a_vals[:, reg]
    for reg in range(2):
        k, n = _b_coords(reg)
        Bm[k, n] = b_vals[:, reg]
    return A @ Bm


class Kernel:
    """The kernel's index expressions for a cell at padded width ``H`` (one
    block's slice, one launch's rows ``R``)."""

    def __init__(self, cell, H, R=16):
        self.cell, self.H, self.R = cell, H, R
        self.gates = G_OF[cell]
        self.p = wm.plan(H, self.gates)
        self.ugs = wm.UNIT_GROUP[self.gates]
        self.group_rows = self.gates * self.ugs  # 32 / 48
        self.WS, self.DS = H + 8, self.p.NC + 8

    def a_rec(self, ug, j, kk):
        """Recompute A: a_rec + j·16·WS + kk·16 (flat index into s_w)."""
        WS = self.WS
        return lambda ln: ((ug * self.group_rows + (ln & 7) + 8 * ((ln >> 3) & 1)) * WS
                           + 8 * (ln >> 4) + j * 16 * WS + kk * 16)

    def b_rec(self, nt, kk):
        """Recompute B (two k-steps): s_h + (nt·8 + ld_row)·WS + kk·16 + ld_mat·8."""
        return lambda ln: (nt * 8 + (ln & 7)) * self.WS + kk * 16 + (ln >> 3) * 8

    def a_dh(self, mt, kk):
        """Chained product A (trans): s_w + (8(ld_mat >> 1) + ld_row)·WS + mt·16 + 8(ld_mat & 1) + kk·16·WS."""
        WS = self.WS
        return lambda ln: (8 * (ln >> 4) + (ln & 7)) * WS + mt * 16 + 8 * ((ln >> 3) & 1) + kk * 16 * WS

    def b_dh(self, n, kk):
        """Chained product B: s_dg + ld_row·DS + 8(ld_mat & 1) + n·8·DS + kk·16."""
        return lambda ln: (ln & 7) * self.DS + 8 * ((ln >> 3) & 1) + n * 8 * self.DS + kk * 16

    def z_slot(self, ug):
        """(gate, unit in the block, tile j, element e) the gate phase reads
        from accumulator (j, e) of lane l: ``(32, tiles, 4)`` each."""
        j = torch.arange(self.group_rows // 16)[None, :, None]
        e = torch.arange(4)[None, None, :]
        g = (L // 4)[:, None, None]
        if self.cell == "lstm":  # z[0] = i | f, z[1] = g | o of unit 8ug + l/4
            gate, unit = 2 * j + e // 2, ug * 8 + g + 0 * j
        else:  # z[u] = r | z of unit 16ug + 8u + l/4; z[2] = n of both units
            gate = torch.where(j < 2, e // 2, 2)
            unit = ug * 16 + g + torch.where(j < 2, 8 * j, 8 * (e // 2))
        return gate.expand(32, -1, 4), unit.expand(32, -1, 4)

    def dg_col(self, ug, gate, u):
        """The dz tile column the gate phase writes gate ``gate`` of the
        lane's unit into (LSTM: dgr + 8·gi; GRU: dgr (+ 8, + 32 − 8u) with
        dgr = ug·48 + 16u + g), for lanes ``g = l // 4``."""
        g = L // 4
        if self.cell == "lstm":
            return ug * 32 + g + 8 * gate
        base = ug * 48 + 16 * u + g
        return base + (0 if gate == 0 else 8 if gate == 1 else 32 - 8 * u)

    def slot(self, k):
        """(owner block, slot row) of the partial of unit ``k`` from this
        block: owner = k // Hb, row (rank·Hb + k − owner·Hb)."""
        return k // self.p.Hb, k - (k // self.p.Hb) * self.p.Hb


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("H", [160, 288, 352, 512, 608, 640, 672])
def test_plan_and_packing_round_trip(gates, H):
    if H > wm.max_h(gates):
        with pytest.raises(ValueError):
            wm.rows(8, H, gates, 7)
        return
    p = wm.plan(H, gates)
    assert p.Hb % wm.UNIT_GROUP[gates] == 0 and 1 <= p.U <= 16
    assert (p.U - 1) * p.Hb < H <= p.U * p.Hb and p.NC == gates * p.Hb
    cols = wm.columns(H, p)
    real = cols[cols >= 0]
    assert torch.equal(real.sort().values, torch.arange(gates * H))  # every column once
    gate, unit = wm.block_rows(gates, p.Hb)  # packed row c: gate gate[c] of unit b·Hb + unit[c]
    u = torch.arange(p.U)[:, None] * p.Hb + unit[None, :]
    assert torch.equal(cols, torch.where(u < H, gate * H + u, -1))
    wh = torch.randn(H, gates * H)
    wp = wm.pack_wh(wh, p)
    assert wp.shape == (p.U, p.NC, H)
    assert torch.equal(wm.unpack_wh(wp, p), wh)
    assert torch.equal(wp[cols < 0], torch.zeros_like(wp[cols < 0]))


def test_widths_and_routes():
    """The route takes bf16 past the tensor-core one-block kernels' 128 up
    to where the BPTT's shared memory ends (608 LSTM, 672 GRU: the Pallas
    kernels' 608 / 640 are inside), for the forward and the BPTT alike;
    past it both take the streamed kernels ("wide_mma_stream") up to
    ``stream_max_h``, then the forward "wide" and the BPTT the streamed
    kernels' deep layout up to ``stream_bwd_max_h`` (4096);
    f32 keeps its routes, the BPTT up to 512 on its own cluster kernel."""
    assert (wm.max_h(4), wm.max_h(3)) == (608, 672)
    bf16, f32 = torch.bfloat16, torch.float32
    for cell, gates in (("lstm", 4), ("gru", 3)):
        for H in (129, 200, 256, 264, 336, 512, wm.max_h(gates)):
            assert fwd_route(bf16, H, cell) == bwd_route(bf16, H, cell) == "wide_mma"
        for H in (wm.max_h(gates) + 1, 1024, wide_layout.max_h(gates)):
            streamed = H <= wm.stream_max_h(gates)
            assert fwd_route(bf16, H, cell) == ("wide_mma_stream" if streamed else "wide")
            deep = H <= wm.stream_bwd_max_h(gates)
            assert bwd_route(bf16, H, cell) == ("wide_mma_stream" if deep else "wide")
            assert not wm.fits(H, gates)
        for H in (16, 128):
            assert bwd_route(bf16, H, cell) == "mma"
        assert fwd_route(f32, 512, cell) == bwd_route(f32, 512, cell) == "wide_f32"
        assert bwd_route(f32, 1024, cell) == fwd_route(f32, 1024, cell) == "wide"
        assert bwd_route(f32, 200, cell) == "narrow_f32"


@pytest.mark.parametrize("gates", [4, 3])
def test_rows_a_cluster(gates):
    """The plan's rows at the card's 7 clusters of 16 (chip_smoke.py phases
    13a / 14a): B = 8 and 32 in one wave; at H = 512 no R >= 56 fits shared
    memory, so B = 160 takes two waves of R = 24 (the fewest waves, then the
    fewest rows); narrower layers take B = 160 in one."""
    for B, R in ((8, 8), (32, 16)):
        r = wm.rows(B, 512, gates, 7)
        assert (r.R, r.waves) == (R, 1) and r.smem <= wm.SMEM_OPTIN
    r = wm.rows(160, 512, gates, 7)
    assert (r.R, r.waves) == (24, 2)
    assert wm.smem_bytes(512, gates, 56) > wm.SMEM_OPTIN
    r = wm.rows(160, 288, gates, 7)  # LSTM: 3 unit groups, so at most 5 tiles of 8 rows
    assert (r.R, r.waves) == ((24, 2) if gates == 4 else (56, 1))
    for B in (1, 8, 33, 160):
        r = wm.rows(B, 608 if gates == 4 else 640, gates, 7)
        assert r.R == 8 and r.MPW == 3


@pytest.mark.parametrize("cell,H", [("lstm", 288), ("gru", 352), ("lstm", 512), ("gru", 512)])
def test_fragments_match_the_ptx_layouts(cell, H):
    """Every ldmatrix address of both products gives the mma fragment the
    product needs; the accumulators land on (gate, unit, row) as the gate
    phase reads them; the dz tile and the partial slots are written where
    the chained product and the owner read them."""
    k = Kernel(cell, H)
    p, WS, DS = k.p, k.WS, k.DS
    gate_of, unit_of = wm.block_rows(k.gates, p.Hb)
    rng = np.random.default_rng(0)
    s_w = torch.from_numpy(rng.normal(size=(p.NC, WS))).flatten()  # the W_hᵀ slice rows
    s_h = torch.from_numpy(rng.normal(size=(k.R, WS))).flatten()
    s_dg = torch.from_numpy(rng.normal(size=(k.R, DS))).flatten()
    Wt, Hm, Dg = s_w.view(p.NC, WS), s_h.view(k.R, WS), s_dg.view(k.R, DS)
    for ug in range(p.Hb // k.ugs):
        for kk in range(0, H // 16, 2):
            b = _ldmatrix(k.b_rec(1, kk), 4)  # n-tile 1: rows 8 … 15
            for h in range(2):
                for reg in range(2):  # registers 2h, 2h + 1: b0, b1 of k-step kk + h
                    kc, n = _b_coords(reg)
                    assert torch.equal(b[:, 2 * h + reg] // WS, 8 + n)
                    assert torch.equal(b[:, 2 * h + reg] % WS, 16 * (kk + h) + kc)
                for j in range(k.group_rows // 16):
                    a = _ldmatrix(k.a_rec(ug, j, kk + h), 4)
                    for reg in range(4):
                        m, kc = _a_coords(reg)
                        assert torch.equal(a[:, reg] // WS, ug * k.group_rows + 16 * j + m)
                        assert torch.equal(a[:, reg] % WS, 16 * (kk + h) + kc)
                    d = _mma(s_w[a], s_h[b[:, 2 * h:2 * h + 2]])
                    want = Wt[ug * k.group_rows + 16 * j:][:16, 16 * (kk + h):][:, :16] @ \
                        Hm[8:16, 16 * (kk + h):16 * (kk + h) + 16].T
                    assert torch.allclose(d, want)
        # accumulator (j, e) of lane l is packed row 16j + m of the group, batch row n
        gate, unit = k.z_slot(ug)
        m, n = _d_coords()
        rows = ug * k.group_rows + 16 * torch.arange(k.group_rows // 16)[None, :, None] + m[:, None, :]
        assert torch.equal(gate_of[rows], gate) and torch.equal(unit_of[rows], unit)
        # the dz tile column of (gate, unit) is that unit's packed row
        for u in range(2 if cell == "gru" else 1):
            for gi in range(k.gates):
                col = k.dg_col(ug, gi, u)
                assert torch.equal(gate_of[col], torch.full((32,), gi))
                assert torch.equal(unit_of[col], ug * k.ugs + 8 * u + L // 4)
    for mt in range(H // 16):
        for kk in range(p.NC // 16):
            a = _ldmatrix(k.a_dh(mt, kk), 4, trans=True)
            for reg in range(4):  # A_dh[m][kc] = W_hᵀ slice row 16kk + kc, unit 16mt + m
                m, kc = _a_coords(reg)
                assert torch.equal(a[:, reg] // WS, 16 * kk + kc)
                assert torch.equal(a[:, reg] % WS, 16 * mt + m)
            b = _ldmatrix(k.b_dh(1, kk), 2)
            for reg in range(2):
                kc, n = _b_coords(reg)
                assert torch.equal(b[:, reg] // DS, 8 + n)
                assert torch.equal(b[:, reg] % DS, 16 * kk + kc)
            d = _mma(s_w[a], s_dg[b])
            want = Wt[16 * kk:16 * kk + 16, 16 * mt:16 * mt + 16].T @ Dg[8:16, 16 * kk:16 * kk + 16].T
            assert torch.allclose(d, want)
        # the lane's partials (units 16mt + l/4, + 8; rows 2(l%4), +1) go to
        # the owner's slot rows; every unit of the tile to one slot row
        m, _ = _d_coords()
        units = 16 * mt + m[:, [0, 2]]
        owner, row = k.slot(units)
        assert torch.equal(owner * p.Hb + row, units) and bool((owner < p.U).all())


def _replay_bptt(cell, H):
    """A plain BPTT at padded width ``Hp`` (as the wrapper pads) whose
    recompute and chained product run through the packed slices, the cells'
    accumulator mapping and the owners' block-order sums."""
    gates = G_OF[cell]

    def core(*args):
        T, B, G = args[0].shape
        Hp = G // gates
        p = wm.plan(Hp, gates)
        outs = []
        if cell == "lstm":
            gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b = args
            dirs = ((gx_f, wh_f, hp_f, cp_f, c_f, dy_f, range(T - 1, -1, -1)),
                    (gx_b, wh_b, hp_b, cp_b, c_b, dy_b, range(T)))
        else:
            gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b = args
            dirs = ((gx_f, wh_f, bn_f, hp_f, dy_f, range(T - 1, -1, -1)),
                    (gx_b, wh_b, bn_b, hp_b, dy_b, range(T)))
        for d in dirs:
            wp = wm.pack_wh(d[1], p)
            hp = d[2] if cell == "lstm" else d[3]
            dgx = torch.zeros_like(d[0])
            dnr_out = torch.zeros(T, B, Hp)
            dh_c = torch.zeros(B, Hp)
            dc = torch.zeros(B, Hp)
            for t in d[-1]:
                z = wm.replay_recompute(hp[t], wp, p)  # the blocks' packed rows, back to columns
                if cell == "lstm":
                    gx, hp_, cp_, cs, dy = d[0][t], d[2][t], d[3][t], d[4][t], d[5][t]
                    zz = gx + z
                    i, f = torch.sigmoid(zz[:, :Hp]), torch.sigmoid(zz[:, Hp:2 * Hp])
                    g, o = torch.tanh(zz[:, 2 * Hp:3 * Hp]), torch.sigmoid(zz[:, 3 * Hp:])
                    tc = torch.tanh(cs)
                    dh = dy + dh_c
                    dcn = dc + dh * o * (1 - tc * tc)
                    dz = torch.cat([dcn * g * i * (1 - i), dcn * cp_ * f * (1 - f),
                                    dcn * i * (1 - g * g), dh * tc * o * (1 - o)], -1)
                    dgx[t] = dz
                    dg = dz
                    dc = dcn * f
                else:
                    gx, bn, hp_, dy = d[0][t], d[2], d[3][t], d[4][t]
                    r = torch.sigmoid(gx[:, :Hp] + z[:, :Hp])
                    zg = torch.sigmoid(gx[:, Hp:2 * Hp] + z[:, Hp:2 * Hp])
                    ghn = z[:, 2 * Hp:] + bn
                    n = torch.tanh(gx[:, 2 * Hp:] + r * ghn)
                    dh = dy + dh_c
                    dn = dh * (1 - zg) * (1 - n * n)
                    dr, dzz, dnr = dn * ghn * r * (1 - r), dh * (hp_ - n) * zg * (1 - zg), dn * r
                    dgx[t] = torch.cat([dr, dzz, dn], -1)
                    dnr_out[t] = dnr
                    dg = torch.cat([dr, dzz, dnr], -1)
                # the dz tile in packed columns, then the blocks' partials summed by owners
                dh_c = wm.replay_dh(dg, wp, p) + (dh * zg if cell == "gru" else 0.0)
            outs.append((dgx, dnr_out))
        if cell == "lstm":
            return outs[0][0], outs[1][0]
        return outs[0][0], outs[1][0], outs[0][1], outs[1][1]

    Hp = wm.padded(H)
    return lambda *args: at_width(core, Hp, gates, *args)


@pytest.mark.parametrize("cell,T,B,H", CASES)
def test_replayed_bptt_equals_the_twin(cell, T, B, H):
    gates = G_OF[cell]
    rng = np.random.default_rng(T + B + H)
    f = lambda *s, sc=1.0: torch.from_numpy(rng.normal(size=s) * sc).float()  # noqa: E731
    gx = [f(T, B, gates * H) for _ in range(2)]
    wh = [f(H, gates * H, sc=H ** -0.5) for _ in range(2)]
    if cell == "lstm":
        yf, yb, cf, cb = bilstm_fwd_reference(*gx, *wh, with_cells=True)
        z = torch.zeros_like(yf[:1])
        args = (*gx, *wh, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
                torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, f(T, B, H), f(T, B, H))
        want = bilstm_bwd_reference(*args)
    else:
        bn = [f(H) for _ in range(2)]
        yf, yb = bigru_fwd_reference(*gx, *wh, *bn)
        z = torch.zeros_like(yf[:1])
        args = (*gx, *wh, *bn, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
                f(T, B, H), f(T, B, H))
        want = bigru_bwd_reference(*args)
    got = _replay_bptt(cell, H)(*args)
    scale = max(w.abs().max().item() for w in want)
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        assert (g_ - w).abs().max().item() <= 1e-5 * max(1.0, scale)


# --- the forwards (csrc/{bilstm,bigru}_fwd_wide_mma.cu) --------------------------


@pytest.mark.parametrize("gates", [4, 3])
def test_forward_rows_a_cluster(gates):
    """The forward's plan at the card's 7 clusters of 16 (chip_smoke.py
    phases 13a / 14a) at H = 512: B = 1 and 8 on R = 8, B = 32 on R = 16,
    B = 160 on R = 56, each in one wave. Two h buffers fit the LSTM up to
    R = 40 and the GRU up to R = 56, so at B = 160 the LSTM takes one buffer
    (the split barrier) and the GRU two; an override of R = 40 gives the
    LSTM two buffers in two waves. Where fewer than 4 warps hold a cell the
    idle ones take parts of K: the GRU's 2 cell warps at R = 8 take 8 parts
    each; the LSTM's 4 keep K whole."""
    p = wm.plan(512, gates)
    stage = wm.WARPS * wm.FWD_MAX_TPW * 8 * wm.UNIT_GROUP[gates] * 2
    cells, ksp = (4, 1) if gates == 4 else (2, 8)  # cell warps and K parts at R = 8
    red = (ksp - 1) * cells * (gates * wm.UNIT_GROUP[gates] // 16) * 128 * 4
    assert wm.fwd_smem_bytes(512, gates, 8) == p.NC * 520 * 2 + 8 * 520 * 2 + stage + red
    for B, R, tpw, ksp in ((1, 8, 1, ksp), (8, 8, 1, ksp), (32, 16, 1, 1), (160, 56, 2, 1)):
        r = wm.fwd_rows(B, 512, gates, 7)
        assert (r.R, r.TPW, r.WPG, r.KSP, r.waves) == (R, tpw, -(-R // 8 // tpw), ksp, 1)
        assert r.KSP * (p.Hb // wm.UNIT_GROUP[gates]) * r.WPG <= wm.WARPS
        assert r.dbuf == int(not (gates == 4 and R == 56))
        assert r.smem == wm.fwd_smem_bytes(512, gates, R, 1 + r.dbuf) <= wm.SMEM_OPTIN
    last = 40 if gates == 4 else 56  # the most rows with two h buffers
    assert wm.fwd_split(512, gates, last)[2] == wm.fwd_split(512, gates, last + 8)[2] == 1
    assert wm.fwd_smem_bytes(512, gates, last, 2) <= wm.SMEM_OPTIN
    assert wm.fwd_smem_bytes(512, gates, last + 8, 2) > wm.SMEM_OPTIN
    assert wm.fwd_smem_bytes(512, gates, 64, 1) <= wm.SMEM_OPTIN
    if gates == 4:
        r = wm.fwd_rows(160, 512, 4, 7, rows=40)
        assert (r.R, r.waves, r.dbuf) == (40, 2, 1)


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("H", [160, 288, 352, 512, 608, 640, 672])
def test_forward_plans_at_every_width(gates, H):
    """Wherever the route takes H, the forward has a plan for every B: its
    block within shared memory, at most FWD_MAX_TPW tiles a warp and at most
    16 warps; B <= 32 in one wave; the route's widest widths fit."""
    if not wm.fits(H, gates):
        assert H > wm.max_h(gates)
        return
    nug = wm.plan(H, gates).Hb // wm.UNIT_GROUP[gates]
    for B in (1, 8, 32, 160):
        r = wm.fwd_rows(B, H, gates, 7)
        assert 8 <= r.R <= wm.MAX_ROWS and r.R % 8 == 0 and r.smem <= wm.SMEM_OPTIN
        assert r.TPW <= wm.FWD_MAX_TPW and r.WPG * r.TPW >= r.R // 8
        assert r.KSP * nug * r.WPG <= wm.WARPS and (r.KSP == 1 or nug * r.WPG < 4)
        assert r.smem == wm.fwd_smem_bytes(H, gates, r.R, 1 + r.dbuf)
        if B <= 32:
            assert r.waves == 1


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("H,R", [(512, 8), (512, 16), (512, 56), (512, 64), (608, 24), (288, 40),
                                 (672, 16)])
def test_forward_warps_cover_every_cell_once(gates, H, R):
    """The kernels' warp map (warp w: K part w // CW of cell warp
    cw = w % CW, unit group cw // WPG, 8-row tiles cw % WPG + i·WPG for
    i < ntiles) gives every (unit group, tile) cell to one warp of each K
    part, the parts' k-step pairs tiling K in order; the exchange's 16-byte
    chunks (8 units of one row) start 16-byte aligned in the h tile (row
    stride H + 8) and in y."""
    if not wm.fits(H, gates):
        return
    p = wm.plan(H, gates)
    ugs = wm.UNIT_GROUP[gates]
    nug, nt8 = p.Hb // ugs, R // 8
    tpw, wpg, ksp = wm.fwd_split(H, gates, R)
    if tpw > wm.FWD_MAX_TPW:
        return
    cw_n, kp_n = nug * wpg, H // 32  # cell warps, k-step pairs
    seen = []
    for w in range(wm.WARPS):
        kp, cw = w // cw_n, w % cw_n
        ug, wj = cw // wpg, cw % wpg
        ntiles = min(tpw, (nt8 - 1 - wj) // wpg + 1) if kp < ksp and ug < nug and wj < nt8 else 0
        pairs = list(range(kp * kp_n // ksp, (kp + 1) * kp_n // ksp))
        seen += [(ug, wj + i * wpg, kp, tuple(pairs)) for i in range(ntiles)]
    assert sorted(s[:3] for s in seen) == [(u, t, k) for u in range(nug) for t in range(nt8)
                                           for k in range(ksp)]
    for u in range(nug):  # each cell's parts tile the k-step pairs in order
        parts = sorted((k, pr) for uu, t, k, pr in seen if uu == u and t == 0)
        assert [x for _, pr in parts for x in pr] == list(range(kp_n))
    WS = H + 8
    for rank in range(p.U):
        for ug in range(nug):
            for half in range(ugs // 8):
                col = rank * p.Hb + ug * ugs + 8 * half
                if col < H:  # whole chunks of valid units
                    assert col + 8 <= H
                    for rowc in range(R):
                        assert (rowc * WS + col) * 2 % 16 == 0 and (rowc * H + col) * 2 % 16 == 0


def _replay_forward(cell, H):
    """A plain forward at padded width ``Hp`` (as the wrapper pads) whose
    product runs through the packed slices (``replay_recompute``: each
    block's packed rows against the 8-row tiles, K in 16-wide k-steps in
    order, scattered back to columns), h all-gathered as round(h)."""
    gates = G_OF[cell]

    def core(*args, with_cells=False):
        T, B, G = args[0].shape
        Hp = G // gates
        p = wm.plan(Hp, gates)
        outs = []
        if cell == "lstm":
            gx_f, gx_b, wh_f, wh_b = args
            dirs = ((gx_f, wh_f, None, range(T)), (gx_b, wh_b, None, range(T - 1, -1, -1)))
        else:
            gx_f, gx_b, wh_f, wh_b, bn_f, bn_b = args
            dirs = ((gx_f, wh_f, bn_f, range(T)), (gx_b, wh_b, bn_b, range(T - 1, -1, -1)))
        for gx, wh, bn, steps in dirs:
            wp = wm.pack_wh(wh, p)
            dt = gx.dtype
            h = torch.zeros(B, Hp)
            c = torch.zeros(B, Hp)
            y, cs = torch.zeros(T, B, Hp, dtype=dt), torch.zeros(T, B, Hp, dtype=dt)
            for t in steps:
                z = wm.replay_recompute(h.to(dt).float(), wp.float(), p)  # the exchanged round(h)
                if cell == "lstm":
                    zz = gx[t].float() + z
                    i, f = torch.sigmoid(zz[:, :Hp]), torch.sigmoid(zz[:, Hp:2 * Hp])
                    g, o = torch.tanh(zz[:, 2 * Hp:3 * Hp]), torch.sigmoid(zz[:, 3 * Hp:])
                    c = f * c + i * g
                    h = o * torch.tanh(c)
                    cs[t] = c.to(dt)
                else:
                    x = gx[t].float()
                    r = torch.sigmoid(x[:, :Hp] + z[:, :Hp])
                    zg = torch.sigmoid(x[:, Hp:2 * Hp] + z[:, Hp:2 * Hp])
                    n = torch.tanh(x[:, 2 * Hp:] + r * (z[:, 2 * Hp:] + bn.float()))
                    h = (1 - zg) * n + zg * h
                y[t] = h.to(dt)
            outs.append((y, cs))
        (yf, cf), (yb, cb) = outs
        return (yf, yb, cf, cb) if with_cells else (yf, yb)

    Hp = wm.padded(H)
    return lambda *args, **kw: at_width(core, Hp, gates, *args, **kw)


@pytest.mark.parametrize("cell,T,B,H", CASES)
def test_replayed_forward_equals_the_twin(cell, T, B, H):
    """The forward kernels' recurrence (the packed slices' product, the cell
    carries, zero-padded widths) equals ``bilstm_fwd_reference`` (with
    cells) / ``bigru_fwd_reference`` (with ``b_hn``) within 1e-5."""
    gates = G_OF[cell]
    rng = np.random.default_rng(T + B + H + 1)
    f = lambda *s, sc=1.0: torch.from_numpy(rng.normal(size=s) * sc).float()  # noqa: E731
    gx = [f(T, B, gates * H) for _ in range(2)]
    wh = [f(H, gates * H, sc=H ** -0.5) for _ in range(2)]
    if cell == "lstm":
        want = bilstm_fwd_reference(*gx, *wh, with_cells=True)
        got = _replay_forward(cell, H)(*gx, *wh, with_cells=True)
    else:
        bn = [f(H) for _ in range(2)]
        want = bigru_fwd_reference(*gx, *wh, *bn)
        got = _replay_forward(cell, H)(*gx, *wh, *bn)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        assert g_.shape == w.shape and g_.dtype == w.dtype
        assert (g_ - w).abs().max().item() <= 1e-5
