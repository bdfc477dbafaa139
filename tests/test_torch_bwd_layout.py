"""The tensor-core BPTT kernels' lanes and fragments, on the CPU.

``csrc/bilstm_bwd_mma.cu`` and ``csrc/bigru_bwd_mma.cu`` give warp ``w`` the
units ``16w … 16w+15`` and lane ``l`` the units ``16w + l // 4`` and
``16w + 8 + l // 4`` for batch rows ``2·(l % 4)`` and ``2·(l % 4) + 1`` of
each 8-row tile. Each step they

- recompute the gates with ``mma.sync`` from the packed ``W_hᵀ`` in shared
  memory (``ldmatrix`` A fragments, ``ops/mma_layout.py::pack_wh`` order)
  and ``h_prev`` (``ldmatrix`` B fragments), and read every gate out of the
  accumulators the way the kernel's ``recompute_init`` names them;
- write ``dz`` (GRU: ``dr | dz | dnr | dn``) into an 8-row bf16 tile at
  column ``gate·H + unit``;
- run the chained product ``dhᵀ = W_h · dzᵀ``: A fragments read from ``W_h``
  with ``ld_pair`` (M-tile ``w``, K split into one chain per gate block),
  B fragments read from the tile with ``ldmatrix``;
- store ``dgx`` (and ``dnr``) from the tile.

Here the kernels' address arithmetic is replayed in Python: every fragment
is checked against the PTX layout of ``mma.m16n8k16`` and ``ldmatrix``, and a
plain BPTT that takes its operands through those addresses (gates read lane
by lane from the packed product, ``dz`` written to and read back from the
tile, ``W_h`` assembled from the A fragments) must equal the twins
``bilstm_bwd_reference`` / ``bigru_bwd_reference`` exactly in f32. The sums
are the twins' own: the packed recompute is the same sums over the same
``(H, G)`` layout, and the chained product the same sum over K in the same
order. The kernels add their K chains at the end, a reassociation in f32
that these tests cannot make exact; the card holds the kernels to the twins
within a tolerance (``tests/test_torch_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops.gru_cuda import bigru_bwd_reference, bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_bwd_reference, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import GATES, bwd_route, fwd_route, gate_rows, pack_wh

ROWS = 8  # batch rows a block: the mma's N
L = torch.arange(32)  # lanes


def _ldmatrix(addr, n_mats):
    """``(32, n_mats, 2)`` flat shared-memory indices each lane receives:
    register ``i`` holds row ``lane // 4`` of matrix ``i``, elements
    ``2·(lane % 4)`` and ``+1``; row ``ρ`` of matrix ``i`` starts at the
    address that lane ``8i + ρ`` gives (``addr(lane)``)."""
    i = torch.arange(n_mats)[None, :, None]
    h = torch.arange(2)[None, None, :]
    lane = L[:, None, None]
    return addr(8 * i + lane // 4) + 2 * (lane % 4) + h


def _a_coords(reg):
    """``(m, k)`` of A-fragment register ``reg`` (pairs h = 0, 1) for each lane."""
    lane = L[:, None]
    h = torch.arange(2)[None, :]
    return lane // 4 + 8 * (reg % 2) + 0 * h, 8 * (reg // 2) + 2 * (lane % 4) + h


class Maps:
    """The kernel's indices for ``kind`` ("lstm"/"gru") at width ``H``,
    checked against the mma/ldmatrix fragment layouts as they are built."""

    def __init__(self, kind, H):
        self.kind, self.H = kind, H
        self.KT, self.warps = H // 16, H // 16
        self.tiles = GATES[kind]  # recompute m16 tiles a warp: 16 units × gates
        self.G = self.tiles * H
        self.WS, self.HS = H + 8, H + 8  # packed W_hᵀ, h_prev tile row strides
        self.DS = 4 * H + 8  # dz tile row stride (GRU: dr | dz | dnr | dn)
        self._recompute()
        self._chained()
        self._gate_phase()

    def _recompute(self):
        KT, WS, HS, tiles = self.KT, self.WS, self.HS, self.tiles
        packed = torch.empty((self.warps, 32, tiles, 4), dtype=torch.int64)
        for w in range(self.warps):
            for j in range(tiles):
                for i in range(KT):
                    # wa_s + j·16·WS + i·16: rows 16·tiles·w + 16j + ld_row + 8(ld_mat & 1), column 8(ld_mat >> 1)
                    a = _ldmatrix(lambda ln: (16 * tiles * w + 16 * j + (ln & 7) + 8 * ((ln >> 3) & 1)) * WS
                                  + i * 16 + 8 * (ln >> 4), 4)
                    for reg in range(4):
                        m, k = _a_coords(reg)
                        assert torch.equal(a[:, reg] // WS, 16 * tiles * w + 16 * j + m)
                        assert torch.equal(a[:, reg] % WS, 16 * i + k)
                    # accumulator element e is A row l // 4 + 8(e // 2)
                    packed[w, :, j] = (a[:, [0, 0, 1, 1], 0] // WS)
                # h_prev's B fragments for k-step i: hps + ld_row·HS + 16i + 8(ld_mat & 1)
                b = _ldmatrix(lambda ln: (ln & 7) * HS + 16 * i + 8 * ((ln >> 3) & 1), 2)
                for reg in range(2):
                    assert torch.equal(b[:, reg] // HS, (L // 4)[:, None].expand(32, 2))
                    assert torch.equal(b[:, reg] % HS, 16 * i + 8 * reg + 2 * (L % 4)[:, None]
                                       + torch.arange(2))
        w = torch.arange(self.warps)[:, None, None, None]
        lane = L[None, :, None, None]
        j = torch.arange(tiles)[None, None, :, None]
        e = torch.arange(4)[None, None, None, :]
        if self.kind == "lstm":  # z[2u] = i | f, z[2u+1] = g | o of units[u]
            unit, gate = 16 * w + 8 * (j // 2) + lane // 4, 2 * (j % 2) + e // 2
        else:  # z[u] = r | z of units[u] (u < 2), z[2] = n of units[0] | units[1]
            unit = 16 * w + lane // 4 + torch.where(j < 2, 8 * j, 8 * (e // 2))
            gate = torch.where(j < 2, e // 2, 2)
        self.z_packed = packed
        self.z_unit, self.z_gate = unit.expand_as(packed), gate.expand_as(packed)
        self.z_row = (2 * (lane % 4) + e % 2).expand_as(packed)  # the accumulator's column n
        # the kernel reads element (w, l, j, e) as gate z_gate of unit z_unit:
        # pack_wh must have put exactly that column of W_h there
        assert torch.equal(gate_rows(self.kind, self.H)[packed], self.z_gate * self.H + self.z_unit)

    def _chained(self):
        H, KT, G, DS = self.H, self.KT, self.G, self.DS
        chains = self.tiles  # one per gate block of K
        # A: ld_pair(W_h + units[0]·G + 2(l % 4) + 16kk (+8G, +8, +8G+8)), kk = c·KT + i
        a_idx = torch.empty((self.warps, chains * KT, 32, 4, 2), dtype=torch.int64)
        offs = (0, 8 * G, 8, 8 * G + 8)
        for w in range(self.warps):
            base = (16 * w + L // 4) * G + 2 * (L % 4)
            for kk in range(chains * KT):
                for reg in range(4):
                    idx = base[:, None] + kk * 16 + offs[reg] + torch.arange(2)
                    m, k = _a_coords(reg)
                    assert torch.equal(idx // G, 16 * w + m) and torch.equal(idx % G, 16 * kk + k)
                    a_idx[w, kk, :, reg] = idx
        self.a_idx = a_idx
        # B: ldmatrix from the dz tile, dgr = dzt + ld_row·DS + 8(ld_mat & 1); the
        # GRU loads chains (0, 1) with x4 and 2 with x2, the LSTM (0, 1) and (2, 3) with x4
        loads = [(0, 1), (2,)] if self.kind == "gru" else [(0, 1), (2, 3)]
        b_idx = torch.empty((chains * KT, 32, 2, 2), dtype=torch.int64)
        for i in range(KT):
            for load in loads:
                def addr(ln, load=load, i=i):
                    mat = ln >> 3
                    ks = load[0] * KT + i if len(load) == 1 else torch.where(
                        mat < 2, load[0] * KT + i, load[1] * KT + i)
                    return (ln & 7) * DS + 8 * (mat & 1) + ks * 16
                got = _ldmatrix(addr, 2 * len(load))
                for reg in range(2 * len(load)):
                    c, breg = load[reg // 2], reg % 2
                    kk = c * KT + i
                    assert torch.equal(got[:, reg] // DS, (L // 4)[:, None].expand(32, 2))
                    assert torch.equal(got[:, reg] % DS, 16 * kk + 8 * breg + 2 * (L % 4)[:, None]
                                       + torch.arange(2))
                    b_idx[kk, :, breg] = got[:, reg]
        self.b_idx = b_idx
        # the accumulator of M-tile w: element e of lane l is unit 16w + l//4 + 8(e//2), row 2(l%4) + e%2
        e = torch.arange(4)
        self.acc_unit = 16 * torch.arange(self.warps)[:, None, None] + (L // 4)[None, :, None] + 8 * (e // 2)
        self.acc_row = (2 * (L % 4)[:, None] + e % 2).expand(32, 4)

    def _gate_phase(self):
        # lane l of warp w: units[u] = 16w + 8u + l//4, rows r0 + e; the carry element 2u + e
        u = torch.arange(2)[:, None]
        e = torch.arange(2)[None, :]
        self.cell_unit = (16 * torch.arange(self.warps)[:, None, None, None] + 8 * u
                          + (L // 4)[None, :, None, None]).expand(self.warps, 32, 2, 2).reshape(
                              self.warps, 32, 4)
        self.cell_row = (2 * (L % 4)[:, None, None] + e).expand(32, 2, 2).reshape(32, 4)

    # --- the plain BPTT through these indices ---

    def gates(self, zp, n_gates):
        """``(n_gates, B, H)`` read lane by lane from the packed ``zp (B, G)``;
        every (gate, row, unit) exactly once."""
        B = zp.shape[0]
        nblk = -(-B // ROWS)
        zpad = torch.cat([zp, zp.new_zeros((nblk * ROWS - B, zp.shape[1]))])
        rows = (torch.arange(nblk)[:, None] * ROWS + self.z_row.flatten()[None]).flatten()
        cols = self.z_packed.flatten().repeat(nblk)
        gate, unit = self.z_gate.flatten().repeat(nblk), self.z_unit.flatten().repeat(nblk)
        out = torch.full((n_gates, nblk * ROWS, self.H), float("nan"))
        seen = torch.zeros_like(out, dtype=torch.int64)
        out[gate, rows, unit] = zpad[rows, cols]
        seen.index_put_((gate, rows, unit), torch.ones_like(rows), accumulate=True)
        assert bool((seen[gate.unique()] == 1).all()), "a gate of a cell is read twice or never"
        return out[:, :B]

    def tile(self, blocks, B):
        """The 8-row dz tiles ``(nblk, 8, DS)``: ``blocks[g] (B, H)`` written at
        column g·H + unit by the lanes that own each cell."""
        nblk = -(-B // ROWS)
        t = torch.full((nblk, ROWS, self.DS), float("nan"))
        unit, row = self.cell_unit.flatten(), self.cell_row.flatten().repeat(self.warps)
        for g, x in enumerate(blocks):
            xp = torch.cat([x, x.new_zeros((nblk * ROWS - B, self.H))]).view(nblk, ROWS, self.H)
            t[:, row, g * self.H + unit] = xp[:, row, unit]
        return t

    def chained(self, tile, wh, B):
        """``(dz read through the B fragments) @ (W_h assembled from the A
        fragments)ᵀ``; K = the chains' k-steps in order."""
        K = self.a_idx.shape[1] * 16
        a = torch.full((self.H, K), float("nan"))
        w, kk, lane, reg, h = (x.flatten() for x in torch.meshgrid(
            *(torch.arange(n) for n in self.a_idx.shape), indexing="ij"))
        m, k = lane // 4 + 8 * (reg % 2), 16 * kk + 8 * (reg // 2) + 2 * (lane % 4) + h
        a[16 * w + m, k] = wh.flatten()[self.a_idx.flatten()]
        assert torch.equal(a, wh)  # every W_h element of M-tile w and chain k-step, once
        kk, lane, breg, h = (x.flatten() for x in torch.meshgrid(
            *(torch.arange(n) for n in self.b_idx.shape), indexing="ij"))
        k = 16 * kk + 8 * breg + 2 * (lane % 4) + h
        flat = tile.reshape(tile.shape[0], -1)
        dz = torch.full((tile.shape[0], ROWS, K), float("nan"))
        dz[:, lane // 4, k] = flat[:, self.b_idx.flatten()]
        dz = dz.reshape(-1, K)[:B].contiguous()
        return dz @ a.T

    def stores(self, tile, B):
        """The rows of the tile as the kernel's 16-byte stores write them:
        LSTM ``dgx``; GRU ``(dgx, dnr)`` (columns dr | dz | dn, and dnr)."""
        H = self.H
        rows = tile.reshape(-1, self.DS)[:B]
        if self.kind == "lstm":
            return rows[:, :4 * H]
        return torch.cat([rows[:, :2 * H], rows[:, 3 * H:4 * H]], dim=-1), rows[:, 2 * H:3 * H]


def _lstm_by_lanes(maps, gx, wh, hp, cp, cs, dy, steps):
    T, B, G = gx.shape
    H = G // 4
    rows = gate_rows("lstm", H)
    w_packed = pack_wh(wh, "lstm").t().contiguous()  # (H, G), columns in packed order
    gxp = gx[..., rows]
    dh_carry = torch.zeros((B, H))
    dc_carry = torch.zeros((B, H))
    dgx = torch.empty_like(gx)
    for t in steps:
        pre = maps.gates(gxp[t] + hp[t] @ w_packed, 4)
        i, f, o = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
        g = torch.tanh(pre[2])
        c, cprev = cs[t], cp[t]
        tc = torch.tanh(c)
        dh = dy[t] + dh_carry
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        tile = maps.tile([dc * g * i * (1.0 - i), dc * cprev * f * (1.0 - f),
                          dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], B)
        dgx[t] = maps.stores(tile, B)
        dh_carry = maps.chained(tile, wh, B)
        dc_carry = dc * f
    return dgx


def _gru_by_lanes(maps, gx, wh, bn, hp, dy, steps):
    T, B, G = gx.shape
    H = G // 3
    w_packed = pack_wh(wh, "gru").t().contiguous()
    dh_carry = torch.zeros((B, H))
    dgx, dnr = torch.empty_like(gx), torch.empty_like(hp)
    for t in steps:
        hprev, x = hp[t], gx[t]
        gh = maps.gates(hprev @ w_packed, 3)
        r = torch.sigmoid(x[:, :H] + gh[0])
        z = torch.sigmoid(x[:, H:2 * H] + gh[1])
        ghn = gh[2] + bn
        n = torch.tanh(x[:, 2 * H:] + r * ghn)
        dh = dy[t] + dh_carry
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        tile = maps.tile([dn_pre * ghn * r * (1.0 - r), dh * (hprev - n) * z * (1.0 - z),
                          dn_pre * r, dn_pre], B)
        dgx[t], dnr[t] = maps.stores(tile, B)
        dh_carry = dh * z + maps.chained(tile, wh, B)
    return dgx, dnr


def _lstm_args(T, B, H, seed):
    rng = np.random.default_rng(seed)
    gx = torch.from_numpy(rng.normal(size=(2, T, B, 4 * H)).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    yf, yb, cf, cb = bilstm_fwd_reference(gx[0], gx[1], wh[0], wh[1], with_cells=True)
    z = torch.zeros_like(yf[:1])
    dy = torch.from_numpy(rng.normal(size=(2, T, B, H)).astype(np.float32))
    return (gx[0], gx[1], wh[0], wh[1], torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, dy[0], dy[1])


def _gru_args(T, B, H, seed):
    rng = np.random.default_rng(seed)
    gx = torch.from_numpy(rng.normal(size=(2, T, B, 3 * H)).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H)).astype(np.float32))
    bn = torch.from_numpy(rng.normal(size=(2, H)).astype(np.float32))
    yf, yb = bigru_fwd_reference(gx[0], gx[1], wh[0], wh[1], bn[0], bn[1])
    z = torch.zeros_like(yf[:1])
    dy = torch.from_numpy(rng.normal(size=(2, T, B, H)).astype(np.float32))
    return (gx[0], gx[1], wh[0], wh[1], bn[0], bn[1], torch.cat([z, yf[:-1]]),
            torch.cat([yb[1:], z]), dy[0], dy[1])


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("H", [16, 48, 128])
def test_fragments_follow_the_mma_and_ldmatrix_layouts(kind, H):
    """The checks in :class:`Maps` (each fragment address against the PTX
    layouts, the packed rows against the gates the lanes read), and: the
    chained product's accumulator lands on the lane that owns its cells in
    the gate phase; the gate phase writes every cell of the tile once."""
    maps = Maps(kind, H)
    assert torch.equal(maps.acc_unit, maps.cell_unit)
    assert torch.equal(maps.acc_row, maps.cell_row)
    cells = maps.cell_unit.flatten() * ROWS + maps.cell_row.flatten().repeat(maps.warps)
    assert torch.equal(torch.bincount(cells, minlength=H * ROWS), torch.ones(H * ROWS, dtype=torch.int64))
    # the chains split K into its gate blocks, in order
    assert maps.a_idx.shape[1] * 16 == maps.G and maps.b_idx.shape[0] * 16 == maps.G


@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("B", [8, 11])
def test_lstm_bptt_through_the_lanes_equals_the_twin(B, H):
    T = 4
    args = _lstm_args(T, B, H, seed=B + H)
    want_f, want_b = bilstm_bwd_reference(*args)
    gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b = args
    maps = Maps("lstm", H)
    assert torch.equal(_lstm_by_lanes(maps, gx_f, wh_f, hp_f, cp_f, c_f, dy_f, range(T - 1, -1, -1)),
                       want_f)
    assert torch.equal(_lstm_by_lanes(maps, gx_b, wh_b, hp_b, cp_b, c_b, dy_b, range(T)), want_b)


@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("B", [8, 11])
def test_gru_bptt_through_the_lanes_equals_the_twin(B, H):
    T = 4
    args = _gru_args(T, B, H, seed=B + H + 1)
    dgx_f, dgx_b, dnr_f, dnr_b = bigru_bwd_reference(*args)
    gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b = args
    maps = Maps("gru", H)
    got_f = _gru_by_lanes(maps, gx_f, wh_f, bn_f, hp_f, dy_f, range(T - 1, -1, -1))
    got_b = _gru_by_lanes(maps, gx_b, wh_b, bn_b, hp_b, dy_b, range(T))
    assert torch.equal(got_f[0], dgx_f) and torch.equal(got_f[1], dnr_f)
    assert torch.equal(got_b[0], dgx_b) and torch.equal(got_b[1], dnr_b)


@pytest.mark.parametrize("dtype,H,route", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 16, "mma"), (torch.bfloat16, 48, "mma"),
    (torch.float32, 128, "simt"), (torch.bfloat16, 40, "simt"), (torch.bfloat16, 160, "wide"),
    (torch.float16, 128, "simt"),
])
def test_bptt_route_is_chosen_from_dtype_and_width(dtype, H, route):
    """The BPTT takes the forward's route: the one-block tensor cores where
    the forward does, and where a bf16 call goes to a cluster of blocks
    (``"wide"`` in the table), the tensor-core cluster kernels of both;
    but at the one-block CUDA-core kernels' widths (``"simt"`` in the table)
    both f32 passes take their f32 cluster kernels (``"narrow_f32"``)."""
    want = "wide_mma" if route == "wide" else route
    f32_narrow = dtype == torch.float32 and want == "simt"
    assert fwd_route(dtype, H) == ("narrow_f32" if f32_narrow else want)
    assert bwd_route(dtype, H) == ("narrow_f32" if f32_narrow else want)
