"""The tensor-core forward kernels' layout, on the CPU.

``csrc/bilstm_fwd_mma.cu`` and ``csrc/bigru_fwd_mma.cu`` read ``W_hᵀ``
packed with its gate rows permuted (``ops/mma_layout.py::pack_wh``) and
give each lane the accumulator elements that ``_lane_rows`` names. Here a plain
forward computes the recurrent product in that packed order, reads every
gate back the way a kernel thread does (LSTM: tile 0 = i | f, tile 1 = g | o
of unit ``8w + lane // 4``; GRU: tiles r | z of units ``16w + lane // 4`` and
``16w + 8 + lane // 4``, tile 2 n of both) for batch rows
``2·(lane % 4) + e % 2`` of each 8-row tile, and must equal the plain twins
``bilstm_fwd_reference`` / ``bigru_fwd_reference`` exactly in f32: the
product in packed order is the same sums over the same (H, G) layout, and
the gate math runs on the same (B, H) tensors. The kernels themselves are
held against the twins on the card (``tests/test_torch_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops.gru_cuda import bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import GATES, bwd_route, fwd_route, gate_rows, pack_wh, unpack_wh

ROWS = 8  # batch rows a block: the mma's N


def _lane_rows(kind, H):
    """``(warps, 32, tiles, 4)``: the packed row of each accumulator element
    of each lane, as the kernels load their A fragments (warp ``w``'s tile
    ``j`` is packed rows ``w·16·tiles + 16·j`` …; element ``e`` is tile row
    ``l // 4 + 8·(e // 2)``)."""
    tiles = 2 if kind == "lstm" else 3
    w = torch.arange(GATES[kind] * H // (16 * tiles))[:, None, None, None]
    lane = torch.arange(32)[None, :, None, None]
    tile = torch.arange(tiles)[None, None, :, None]
    e = torch.arange(4)[None, None, None, :]
    return w * 16 * tiles + tile * 16 + lane // 4 + 8 * (e // 2)


def _lane_gates(lanes, zp, n_gates, unit_of, gate_of):
    """(n_gates, B, H) pre-activations read from the packed ``zp (B, G)``
    lane by lane: element ``e`` of tile ``j`` of lane ``l`` in warp ``w`` is
    gate ``gate_of(j, e)`` of unit ``unit_of(w, l, j, e)`` at batch row
    ``2·(l % 4) + e % 2`` of each 8-row tile. Every (gate, row, unit) must be
    read exactly once."""
    B = zp.shape[0]
    H = zp.shape[1] // n_gates
    w, l, j, e = (x.flatten() for x in torch.meshgrid(
        *(torch.arange(n) for n in lanes.shape), indexing="ij"))
    ix = list(zip(w.tolist(), l.tolist(), j.tolist(), e.tolist()))
    unit = torch.tensor([unit_of(*i) for i in ix])
    gate = torch.tensor([gate_of(i[2], i[3]) for i in ix])
    packed = lanes.flatten()
    out = torch.full((n_gates, B, H), float("nan"))
    seen = torch.zeros((n_gates, B, H), dtype=torch.int64)
    for b0 in range(0, B, ROWS):
        row = b0 + 2 * (l % 4) + e % 2
        ok = row < B
        out[gate[ok], row[ok], unit[ok]] = zp[row[ok], packed[ok]]
        seen.index_put_((gate[ok], row[ok], unit[ok]), torch.ones(int(ok.sum()), dtype=torch.int64),
                        accumulate=True)
    assert bool((seen == 1).all()), "a gate of a unit is read twice or never"
    return out


def _lstm_by_lanes(gx, wh, steps):
    T, B, G = gx.shape
    H = G // 4
    rows, lanes = gate_rows("lstm", H), _lane_rows("lstm", H)
    w_packed = pack_wh(wh, "lstm").t().contiguous()  # (H, G), columns in packed order
    gxp = gx[..., rows]
    h = torch.zeros((B, H))
    c = torch.zeros((B, H))
    ys = {}
    for t in steps:
        zp = gxp[t] + h @ w_packed
        pre = _lane_gates(lanes, zp, 4, lambda w, l, j, e: 8 * w + l // 4,
                          lambda j, e: 2 * j + e // 2)  # i|f, g|o
        i, f, o = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
        g = torch.tanh(pre[2])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t] = h
    return torch.stack([ys[t] for t in range(T)])


def _gru_by_lanes(gx, wh, bn, steps):
    T, B, G = gx.shape
    H = G // 3
    rows, lanes = gate_rows("gru", H), _lane_rows("gru", H)
    w_packed = pack_wh(wh, "gru").t().contiguous()

    def unit_of(w, l, j, e):  # tiles r|z (units 0–7), r|z (8–15), n (0–7 | 8–15)
        return 16 * w + l // 4 + (8 * j if j < 2 else 8 * (e // 2))

    def gate_of(j, e):
        return e // 2 if j < 2 else 2

    h = torch.zeros((B, H))
    ys = {}
    for t in steps:
        ghp = h @ w_packed
        gh = _lane_gates(lanes, ghp, 3, unit_of, gate_of)
        xg = _lane_gates(lanes, gx[t][:, rows], 3, unit_of, gate_of)
        r = torch.sigmoid(xg[0] + gh[0])
        z = torch.sigmoid(xg[1] + gh[1])
        n = torch.tanh(xg[2] + r * (gh[2] + bn))
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack([ys[t] for t in range(T)])


def _arrays(T, B, H, gates, seed):
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(2, T, B, gates * H)).astype(np.float32)
    wh = (rng.normal(size=(2, H, gates * H)) / np.sqrt(H)).astype(np.float32)
    bn = rng.normal(size=(2, H)).astype(np.float32)
    return [torch.from_numpy(a) for a in (*gx, *wh, *bn)]


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("H", [16, 64, 128])
def test_pack_is_a_row_permutation_and_unpack_inverts_it(kind, H):
    G = (4 if kind == "lstm" else 3) * H
    rows = gate_rows(kind, H)
    assert sorted(rows.tolist()) == list(range(G))
    wh = torch.from_numpy(np.random.default_rng(H).normal(size=(H, G)).astype(np.float32))
    wp = pack_wh(wh, kind)
    assert wp.shape == (G, H) and wp.is_contiguous()
    assert torch.equal(wp, wh.t()[rows])
    assert torch.equal(unpack_wh(wp, kind), wh)
    assert torch.equal(pack_wh(unpack_wh(wp, kind), kind), wp)
    bf = wh.to(torch.bfloat16)
    assert torch.equal(unpack_wh(pack_wh(bf, kind), kind), bf)
    # the accumulator rows of the lanes, the rows their A fragments load:
    # each packed row once per warp tile, in 4 lanes × 2 batch rows
    lanes = _lane_rows(kind, H)
    assert lanes.shape == (G // (32 if kind == "lstm" else 48), 32, 2 if kind == "lstm" else 3, 4)
    assert torch.equal(torch.bincount(lanes.flatten()), torch.full((G,), 8))


@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("T,B", [(5, 11), (3, 8)])
def test_lstm_through_the_packed_lanes_equals_the_twin(T, B, H):
    gx_f, gx_b, wh_f, wh_b, *_ = _arrays(T, B, H, 4, seed=T + H)
    want_f, want_b = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b)
    assert torch.equal(_lstm_by_lanes(gx_f, wh_f, range(T)), want_f)
    assert torch.equal(_lstm_by_lanes(gx_b, wh_b, range(T - 1, -1, -1)), want_b)


@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("T,B", [(5, 11), (3, 8)])
def test_gru_through_the_packed_lanes_equals_the_twin(T, B, H):
    gx_f, gx_b, wh_f, wh_b, bn_f, bn_b = _arrays(T, B, H, 3, seed=T + H + 1)
    want_f, want_b = bigru_fwd_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    assert torch.equal(_gru_by_lanes(gx_f, wh_f, bn_f, range(T)), want_f)
    assert torch.equal(_gru_by_lanes(gx_b, wh_b, bn_b, range(T - 1, -1, -1)), want_b)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("H", [8, 40, 144, 256])
def test_widths_outside_the_tensor_core_route_are_refused(kind, H):
    G = (4 if kind == "lstm" else 3) * H
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        pack_wh(torch.zeros((H, G)), kind)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        gate_rows(kind, H)
    # the CUDA-core kernels one block a direction, or past H = 128 in bf16
    # the tensor-core cluster kernels ("wide_mma", ops/wide_mma_layout.py),
    # the forward's and the BPTT's
    route = "wide_mma" if H > 128 else "simt"
    assert fwd_route(torch.bfloat16, H, kind) == route
    assert bwd_route(torch.bfloat16, H, kind) == route


def test_route_is_chosen_from_dtype_and_width():
    assert fwd_route(torch.bfloat16, 128) == "mma"
    assert fwd_route(torch.bfloat16, 64) == "mma"
    assert fwd_route(torch.bfloat16, 16) == "mma"
    assert fwd_route(torch.float32, 128) == "narrow_f32"  # f32: the parity dtype
    assert fwd_route(torch.bfloat16, 48) == "mma"
    # above the register budget: the tensor-core cluster kernels, the LSTM's
    # and the GRU's
    assert fwd_route(torch.bfloat16, 136) == "wide_mma"
    assert fwd_route(torch.bfloat16, 136, "gru") == "wide_mma"
    for dtype, H in ((torch.bfloat16, 128), (torch.bfloat16, 16),
                     (torch.bfloat16, 136), (torch.float32, 1024)):
        for cell in ("lstm", "gru"):  # the BPTT follows the forward
            assert bwd_route(dtype, H, cell) == fwd_route(dtype, H, cell)
    for cell in ("lstm", "gru"):  # but f32 up to 512 has its own cluster kernels
        assert fwd_route(torch.float32, 512, cell) == "wide_f32"
        assert bwd_route(torch.float32, 512, cell) == "wide_f32"
        assert fwd_route(torch.float32, 128, cell) == "narrow_f32"
        assert bwd_route(torch.float32, 128, cell) == "narrow_f32"
    with pytest.raises(ValueError, match="kind"):
        gate_rows("rnn", 64)
