"""The tensor-core wide kernels (route ``"wide_mma"``): how the BPTTs
``csrc/bilstm_bwd_wide_mma.cu`` / ``csrc/bigru_bwd_wide_mma.cu`` and the
forwards ``csrc/bilstm_fwd_wide_mma.cu`` / ``csrc/bigru_fwd_wide_mma.cu``
split one direction's units over a cluster of blocks, which widths they take,
the rows a cluster they choose, and the per-block packing of ``W_hᵀ`` that
all four read.

As on the ``"wide"`` route (``ops/wide_layout.py``), a direction and tile of
batch rows runs on a thread-block cluster of ``U <= 16`` blocks, block ``b``
owning units ``b·Hb … b·Hb + Hb − 1`` (fewer in the last block) with all of
their gates. Here ``Hb`` is a whole number of unit groups (``UNIT_GROUP``: 8
units for the LSTM, 16 for the GRU), and a block's ``NC = gates·Hb`` gate
columns are packed as ``W_hᵀ`` rows in the order of the tensor-core
forwards (``ops/mma_layout.py``): for each unit group the LSTM's m16 tiles
``i|f``, ``g|o`` of its 8 units, the GRU's ``r|z`` of units 0–7, ``r|z`` of
8–15, ``n`` of 0–7 | ``n`` of 8–15 (:func:`block_rows`). :func:`pack_wh`
gives ``(U, NC, H)``: row ``p`` of block ``b`` is column
``columns(H, p)[b, p]`` of ``W_h``, zero past the last unit.

Both products of a step run on ``mma.sync`` m16n8k16 with the batch rows as
N (8-row tiles) and read their A fragments from that one slice in shared
memory: the recompute ``zᵀ = W_hᵀ slice · h_prevᵀ`` by ``ldmatrix`` (M the
packed rows, K = H), the chained ``dhᵀ = W_h slice · dzᵀ`` by
``ldmatrix.trans`` (M = H units, K the packed rows). Each block's dh partial
for unit ``k`` goes to the block that owns ``k``, which adds the ``U``
partials in block order (:func:`replay_dh`).

The forwards run the recompute's product alone, ``zᵀ = W_hᵀ slice · hᵀ``
on the same slice, with the cell carries in the registers the accumulators
land in; each step's bf16 ``round(h)`` is all-gathered through distributed
shared memory into every block's ``h`` tile (:func:`replay_recompute` is
their product too, each cell's K in ``KSP`` parts added in order). A
forward cell warp takes one unit group and ``TPW`` 8-row tiles, so that each
A fragment feeds ``TPW`` products, and warps that no cell holds take parts
of the cells' K; the launcher picks the rows a cluster, ``TPW``, ``KSP``
and the ``h`` buffers that :func:`fwd_rows` replays (:func:`fwd_smem_bytes`).

The kernels take ``H`` a multiple of 32 (``K_GRANULE``); the wrappers
zero-pad other widths (``ops/lstm_cuda.py::at_width``, exact). The BPTT's
slice, ``h_prev`` tile, partial slots and ``dz`` tile must fit a block's
shared memory (:func:`smem_bytes`, against ``SMEM_OPTIN``, the H100's
227 KB): at 8 rows a cluster that holds up to H = 608 (LSTM) / 672 (GRU)
(:func:`fits`, :func:`max_h`); the forward's block fits there too. Wider
bf16 layers stay on the CUDA-core cluster kernels of ``"wide"``;
``ops/mma_layout.py::fwd_route`` holds the rule, for both passes. The
BPTT's launcher picks the rows a cluster :func:`rows` replays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from percivaltts_tpu_torch.ops.wide_layout import CELLS, MAX_CLUSTER

WARPS = 16  # 512 threads a block
UNIT_GROUP = {4: 8, 3: 16}  # units a unit group by gate count: its m16 tiles hold every gate
K_GRANULE = 32  # H is a whole number of these (k-steps in pairs)
MAX_ROWS = 64  # batch rows a cluster
MAX_MPW = 3  # 16-unit tiles of the dh product a warp
SMEM_OPTIN = 232_448  # dynamic shared memory a block may opt into on the H100 (227 KB)


class Plan(NamedTuple):
    U: int  # blocks in a direction's cluster
    Hb: int  # units a block (the last block may hold fewer)
    NC: int  # packed W_hᵀ rows (gate columns) a block, gates·Hb


FWD_MAX_TPW = 2  # 8-row tiles a forward warp takes


class Rows(NamedTuple):
    R: int  # batch rows a cluster, a multiple of 8
    MPW: int  # 16-unit tiles of the dh product a warp
    waves: int  # ceil(2·ceil(B / R) / clusters)
    dbuf: int  # 1: two buffers of partial slots, one cluster barrier a step
    smem: int  # dynamic shared memory a block, bytes


class FwdRows(NamedTuple):
    R: int  # batch rows a cluster, a multiple of 8
    TPW: int  # 8-row tiles a warp (each A fragment feeds TPW products)
    WPG: int  # warps a unit group, ceil(R / 8 / TPW)
    KSP: int  # parts of K a cell's product is split over (warps a cell)
    waves: int  # ceil(2·ceil(B / R) / clusters)
    dbuf: int  # 1: two h buffers, one cluster barrier a step
    smem: int  # dynamic shared memory a block, bytes


def padded(H: int) -> int:
    """The width the kernels run ``H`` at: the next multiple of 32."""
    return -(-H // K_GRANULE) * K_GRANULE


def _check(H: int, gates: int) -> None:
    if gates not in UNIT_GROUP:
        raise ValueError(f"gates must be one of {tuple(UNIT_GROUP)}, got {gates}")
    if H < K_GRANULE or H % K_GRANULE:
        raise ValueError(f"the tensor-core wide kernels take H a multiple of {K_GRANULE}, got H={H}")


def plan(H: int, gates: int = 4) -> Plan:
    """The cluster split for width ``H`` (a multiple of 32) of a cell with
    ``gates`` gates: the fewest units a block (whole unit groups) that 16
    blocks cover."""
    _check(H, gates)
    ugs = UNIT_GROUP[gates]
    Hb = -(-(-(-H // MAX_CLUSTER)) // ugs) * ugs
    return Plan(-(-H // Hb), Hb, gates * Hb)


def smem_bytes(H: int, gates: int, R: int, bufs: int = 1) -> int:
    """A block's dynamic shared memory at width ``H`` and ``R`` rows a cluster:
    the ``W_hᵀ`` slice (NC × (H + 8) bf16), the ``h_prev`` tile (R × (H + 8)
    bf16), ``bufs`` buffers of partial slots (U × Hb × R f32) and the ``dz``
    tile (R × (NC + 8) bf16), each 16-byte aligned (``wide_mma_common.cuh``)."""
    p = plan(H, gates)
    return (_a16(p.NC * (H + 8) * 2) + _a16(R * (H + 8) * 2) + _a16(bufs * p.U * p.Hb * R * 4)
            + _a16(R * (p.NC + 8) * 2))


def fits(H: int, gates: int = 4) -> bool:
    """Whether the kernels take width ``H`` (padded to a multiple of 32): the
    BPTT's 16-unit tiles at most 3 a warp and its shared memory at 8 rows a
    cluster within ``SMEM_OPTIN`` (the forward's is less)."""
    Hp = padded(H)
    return Hp // 16 <= WARPS * MAX_MPW and smem_bytes(Hp, gates, 8) <= SMEM_OPTIN


@functools.cache
def max_h(gates: int = 4) -> int:
    """The widest H the kernels take (608 for the LSTM, 672 for the GRU)."""
    H = K_GRANULE
    while fits(H + K_GRANULE, gates):
        H += K_GRANULE
    return H


def rows(B: int, H: int, gates: int, clusters: int) -> Rows:
    """The launcher's choice of rows a cluster for ``B`` rows when the card
    holds ``clusters`` clusters at once (``percival_*_bwd_wide_mma_plan``
    reports both): among R = 8 … 64 that fit ``SMEM_OPTIN`` and leave one
    (unit group, 8-row tile) cell a warp (``groups · R / 8 <= 16``), the
    fewest waves, then the smallest R; two buffers of partial slots where
    they fit at that R."""
    p = plan(H, gates)
    groups = p.Hb // UNIT_GROUP[gates]
    mpw = -(-(H // 16) // WARPS)
    best = None
    for R in range(8, MAX_ROWS + 1, 8):
        smem = smem_bytes(H, gates, R)
        if groups * (R // 8) > WARPS or smem > SMEM_OPTIN:
            continue
        waves = -(-2 * -(-B // R) // clusters)
        if best is None or waves < best.waves:
            twice = smem_bytes(H, gates, R, 2)
            dbuf = int(twice <= SMEM_OPTIN)
            best = Rows(R, mpw, waves, dbuf, twice if dbuf else smem)
    if best is None:
        raise ValueError(f"no rows a cluster fit the tensor-core wide {CELLS[gates]} at H={H}")
    return best


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _fwd_smem(H: int, gates: int, R: int, bufs: int, tpw: int, wpg: int, ksp: int) -> int:
    p = plan(H, gates)
    ugs = UNIT_GROUP[gates]
    stage = WARPS * FWD_MAX_TPW * 8 * ugs * 2
    red = (ksp - 1) * (p.Hb // ugs) * wpg * tpw * (gates * ugs // 16) * 4 * 32 * 4
    return _a16(p.NC * (H + 8) * 2) + bufs * _a16(R * (H + 8) * 2) + stage + red


def fwd_split(H: int, gates: int, R: int) -> tuple:
    """``(TPW, WPG, KSP)`` of a forward block at ``R`` rows a cluster
    (``wide_mma_common.cuh::wm_fwd_tpw``, ``wm_fwd_ksp``): the 8-row tiles a
    cell warp takes, as few as the 16 warps allow but 2 from 4 tiles on (so
    that each A fragment read feeds two products); the warps a unit group;
    and, where fewer than 4 warps (the SM's warp schedulers) hold a cell,
    the parts of K that the warps no cell holds take, in powers of two while
    the cell warps times KSP fit 16 warps and each part keeps a pair of
    16-wide k-steps, halved until the block fits ``SMEM_OPTIN`` with one
    ``h`` buffer."""
    nug = plan(H, gates).Hb // UNIT_GROUP[gates]
    nt8 = R // 8
    spread = -(-nt8 // (WARPS // nug))
    tpw = 2 if nt8 >= 4 and spread < 2 else spread
    wpg = -(-nt8 // tpw)
    ksp = 1
    while nug * wpg < 4 and 2 * ksp * nug * wpg <= WARPS and 2 * ksp <= H // 32:
        ksp *= 2
    while ksp > 1 and _fwd_smem(H, gates, R, 1, tpw, wpg, ksp) > SMEM_OPTIN:
        ksp //= 2
    return tpw, wpg, ksp


def fwd_smem_bytes(H: int, gates: int, R: int, bufs: int = 1) -> int:
    """A forward block's dynamic shared memory at width ``H`` and ``R`` rows
    a cluster: the ``W_hᵀ`` slice (NC × (H + 8) bf16), ``bufs`` ``h`` tiles
    (R × (H + 8) bf16), the warps' staging tiles (16 warps × ``FWD_MAX_TPW``
    tiles × 8 rows × a unit group's units, bf16) and the K parts' partial
    sums ((KSP − 1) × cell warps × TPW × the group's m16 tiles × 128 f32)
    (``wide_mma_common.cuh::wm_fwd_smem``)."""
    return _fwd_smem(H, gates, R, bufs, *fwd_split(H, gates, R))


def fwd_rows(B: int, H: int, gates: int, clusters: int, rows: int = 0) -> FwdRows:
    """The forward launcher's choice for ``B`` rows when the card holds
    ``clusters`` clusters at once (``percival_*_fwd_wide_mma_plan`` reports
    both): among R = 8 … 64 whose tiles fall at most ``FWD_MAX_TPW`` to a
    warp and whose block fits ``SMEM_OPTIN`` with one ``h`` buffer, the
    fewest waves, then the smallest R; two ``h`` buffers where they fit at
    that R. ``rows > 0`` takes that R alone (a measurement's override)."""
    best = None
    for R in range(8, MAX_ROWS + 1, 8):
        if rows and R != rows:
            continue
        tpw, wpg, ksp = fwd_split(H, gates, R)
        if tpw > FWD_MAX_TPW or fwd_smem_bytes(H, gates, R) > SMEM_OPTIN:
            continue
        waves = -(-2 * -(-B // R) // clusters)
        if best is None or waves < best.waves:
            twice = fwd_smem_bytes(H, gates, R, 2)
            dbuf = int(twice <= SMEM_OPTIN)
            best = FwdRows(R, tpw, wpg, ksp, waves, dbuf,
                           twice if dbuf else fwd_smem_bytes(H, gates, R))
    if best is None:
        raise ValueError(f"no rows a cluster fit the tensor-core wide {CELLS[gates]} forward "
                         f"at H={H}")
    return best


def block_rows(gates: int, Hb: int) -> tuple:
    """``(gate, unit)`` int64 ``(NC,)`` each: packed row ``p`` of a block holds
    gate ``gate[p]`` of its unit ``unit[p]`` (in the block)."""
    p = torch.arange(gates * Hb)
    half, r = (p // 8) % 2, p % 8
    if gates == 4:  # 32 rows a group of 8 units: tiles i|f, g|o
        group, tile = p // 32, (p // 16) % 2
        return 2 * tile + half, 8 * group + r
    group, tile = p // 48, (p // 16) % 3  # 48 rows a group of 16: r|z, r|z, n|n
    gate = torch.where(tile < 2, half, 2)
    unit = 16 * group + torch.where(tile < 2, 8 * tile, 8 * half) + r
    return gate, unit


def columns(H: int, p: Plan) -> torch.Tensor:
    """``(U, NC)`` int64: the column of ``W_h`` (``gate·H + unit``) that
    block ``b``'s packed row ``c`` holds, −1 past the last unit."""
    gate, unit = block_rows(p.NC // p.Hb, p.Hb)
    u = torch.arange(p.U)[:, None] * p.Hb + unit[None, :]
    return torch.where(u < H, gate[None, :] * H + u, -1)


@functools.lru_cache(maxsize=None)
def _columns_on(H: int, gates: int, device: torch.device) -> torch.Tensor:
    # made once a width and device (a copy from pageable memory at every
    # launch would wait for the stream)
    return columns(H, plan(H, gates)).to(device)


def pack_wh(wh: torch.Tensor, p: Plan) -> torch.Tensor:
    """``(H, gates·H)`` recurrent kernel → ``(U, NC, H)`` contiguous: block
    ``b``'s ``W_hᵀ`` rows in :func:`columns` order, zero past the last unit."""
    H = wh.shape[0]
    gates = p.NC // p.Hb
    if p != plan(H, gates) or wh.shape[1] != gates * H:
        raise ValueError(f"{p} is not the plan of a {tuple(wh.shape)} recurrent kernel")
    cols = _columns_on(H, gates, wh.device)
    packed = wh.t()[cols.clamp(min=0)]  # (U, NC, H)
    return packed.masked_fill((cols < 0)[:, :, None], 0).contiguous()


def unpack_wh(wp: torch.Tensor, p: Plan) -> torch.Tensor:
    """Inverse of :func:`pack_wh`: ``(U, NC, H)`` → ``(H, gates·H)``."""
    H = wp.shape[2]
    cols = columns(H, p)
    wh = wp.new_zeros((H, (p.NC // p.Hb) * H))
    ok = cols >= 0
    wh[:, cols[ok]] = wp[ok].t()
    return wh


def replay_recompute(h: torch.Tensor, wp: torch.Tensor, p: Plan) -> torch.Tensor:
    """``h (R, H) · W_h`` → ``(R, gates·H)`` as the blocks compute it: block
    ``b``'s m16 tiles of packed rows against the 8-row tiles of ``h``, K in
    16-wide k-steps in order, each packed row scattered back to its column."""
    R, H = h.shape
    cols = columns(H, p)
    z = h.new_zeros((R, (p.NC // p.Hb) * H))
    for b in range(p.U):
        acc = h.new_zeros((p.NC, R))
        for kk in range(H // 16):
            acc = acc + wp[b, :, 16 * kk:16 * kk + 16] @ h[:, 16 * kk:16 * kk + 16].t()
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[ok].t()
    return z


def replay_dh(dz: torch.Tensor, wp: torch.Tensor, p: Plan) -> torch.Tensor:
    """``dz (R, gates·H) · W_hᵀ`` → ``(R, H)`` as the blocks compute it: block
    ``b``'s partial ``W_h slice · dz[:, its packed rows]ᵀ`` over K in 16-row
    k-steps in order, the ``U`` partials of unit ``k`` added in block order by
    the block that owns ``k``."""
    R, G = dz.shape
    H = G // (p.NC // p.Hb)
    cols = columns(H, p)
    dh = dz.new_zeros((R, H))
    for b in range(p.U):
        dz_b = torch.where(cols[b] >= 0, dz[:, cols[b].clamp(min=0)], 0.0)  # (R, NC)
        part = dz.new_zeros((H, R))
        for kk in range(p.NC // 16):
            part = part + wp[b, 16 * kk:16 * kk + 16].t() @ dz_b[:, 16 * kk:16 * kk + 16].t()
        dh = dh + part.t()
    return dh
