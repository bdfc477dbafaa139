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
bf16 layers take the streamed kernels of ``"wide_mma_stream"`` (the last
parts of this module: the same split and packed rows, the slice in chunks,
:func:`pack_wh_stream`, the BPTT's :func:`stream_plan` and the forward's
:func:`stream_fwd_plan`): the forward up to :func:`stream_fwd_max_h`, the
BPTT up to :func:`stream_bwd_max_h`, on its deep layout past
:func:`stream_max_h`; ``ops/mma_layout.py::fwd_route`` / ``bwd_route`` hold
the rule. The BPTT's launcher picks the rows a cluster :func:`rows` replays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from percivaltts_tpu_torch.ops.wide_layout import CELLS, MAX_CLUSTER, MAX_H

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


# ---- the streamed BPTT (route "wide_mma_stream", csrc/wide_mma_stream.cuh) --
#
# Past max_h the BPTT's W_hᵀ slice no longer fits a block beside its tiles.
# The streamed kernels (csrc/bilstm_bwd_wide_mma_stream.cu,
# csrc/bigru_bwd_wide_mma_stream.cu) keep plan()'s split and packed rows but
# cut the slice's K = H into CHUNK-wide chunks: the last ``nres`` stay in
# shared memory, the first ``nstr`` stream from L2 every step through a ring
# of RING slots (one TMA copy a chunk, one producer warp), each chunk feeding
# the step's recompute over its k and its dh over its units. The sums run in
# "wide_mma"'s order (replay_recompute, replay_dh). Past stream_max_h that
# 64-k layout no longer fits a block at 8 rows, and the BPTT takes its deep
# layout up to DEEP_MAX_H (stream_bwd_max_h): DEEP_CHUNK-wide chunks, all
# streamed through a ring of as many slots as fit (RING to DEEP_MAX_RING),
# each carrying h_prev's rows at its k; the dh partials through a
# scratch buffer in global memory; PPW (unit group, 8-row tile) pairs a
# compute warp (deep_smem_bytes, STREAM_DEEP_KERNELS). Its sums are the 64-k
# layout's: the recompute's k-steps and each unit's dh over the packed rows
# in order, the partials added in block order.

CHUNK = 64  # k a chunk of the slice
DEEP_CHUNK = 32  # k a chunk of the deep layout
DEEP_HS = DEEP_CHUNK + 8  # row stride of a deep ring slot's h_prev rows (80 bytes)
RING = 3  # shared-memory slots the streamed chunks cycle through (the deep layout: at least)
DEEP_MAX_RING = 8  # ring slots of the deep layout at most
STREAM_WARPS = 16  # 15 compute warps and the producer warp (512 threads: 128 registers)
STREAM_MAX_ROWS = 24  # batch rows a cluster (kernels for 8, 16 and 24)
STREAM_TPW = 2  # 8-row tiles a cell warp takes (each A fragment read once for them)
# the step estimate (ps) the plan weighs rows, chunks and waves by
# (wide_mma_stream.cuh::ws_step_ps): fixed, a streamed packed row of a
# chunk (128 bytes from L2), and R·NC·H / 1024 multiply-adds; fitted to 14
# steps timed on an H100 SXM (PERF.md, PR 24)
STEP_PS, ROW_PS, MAC_PS = 7_540_000, 1261, 1993
# the deep layout's step estimate (ps; wide_mma_stream.cuh::wd_step_ps): fixed,
# a streamed packed row of a chunk (64 bytes from L2) and R·NC·H / 1024
# multiply-adds; fitted to 10 steps timed on an H100 SXM
# (tools/bwd_step_breakdown.py --deep-fit; PERF.md, PR 26)
DEEP_STEP_PS, DEEP_ROW_PS, DEEP_MAC_PS = 8_107_936, 631, 2466
# pairs a compute warp at most in the deep layout, and the (R / 8, pairs a
# compute warp) its kernels are instantiated for: those the deep widths take
# (LSTM 13–32 unit groups a block, GRU 8–16) that fit 128 registers with no
# spill (ptxas on the H100's build: the LSTM's one-tile 3-pair and two- and
# three-tile 4-pair kernels and the GRU's three-tile 2-pair one spilled
# 8–36 B)
DEEP_MAX_PPW = {4: 4, 3: 2}
STREAM_DEEP_KERNELS = {4: ((1, 1), (1, 2), (1, 4), (2, 2), (2, 3), (3, 3)),
                       3: ((1, 1), (1, 2), (2, 2))}
# the deep layout's widest H (wide_mma_stream.cuh::kWdMaxH), MAX_H: 15
# compute warps of the kernels above hold the LSTM's 32 and the GRU's 16
# unit groups a block at 8 rows
DEEP_MAX_H = 4096


class StreamPlan(NamedTuple):
    U: int  # blocks in a direction's cluster
    Hb: int  # units a block
    NC: int  # packed W_hᵀ rows a block
    R: int  # batch rows a cluster, a multiple of 8
    nres: int  # chunks resident in shared memory (the last ones)
    nstr: int  # chunks streamed every step (the first ones)
    clusters: int  # clusters the card holds at once
    waves: int  # ceil(2·ceil(B / R) / clusters)
    dbuf: int  # 1: two buffers of partial slots, one cluster barrier a step
    smem: int  # dynamic shared memory a block, bytes
    chunk: int  # k a chunk: CHUNK, or DEEP_CHUNK in the deep layout
    ppw: int  # deep layout: (unit group, 8-row tile) pairs a compute warp; else 0
    scratch: int  # deep layout: bytes of dh partials a cluster in global memory; else 0
    ring: int  # ring slots: RING, or in the deep layout as many as fit


def chunks(H: int, chunk: int = CHUNK) -> int:
    """Chunks of ``chunk`` k in width ``H`` (the last 64-k one half when H ≡ 32 mod 64)."""
    return -(-H // chunk)


def tile_bytes(NC: int, chunk: int = CHUNK) -> int:
    """Shared-memory bytes of one chunk of a block's slice: NC packed rows × ``chunk`` bf16."""
    return NC * chunk * 2


def stream_smem_bytes(H: int, gates: int, R: int, nres: int, bufs: int = 1) -> int:
    """A streamed block's dynamic shared memory (``wide_mma_stream.cuh::ws_smem``):
    ``RING + nres`` chunk tiles, the ``h_prev`` tile (R × (H + 8) bf16),
    ``bufs`` buffers of partial slots (U × Hb × R f32), the ``dz`` tile
    (R × (NC + 8) bf16) and the ring's ``2·RING`` mbarriers."""
    p = plan(H, gates)
    return ((RING + nres) * tile_bytes(p.NC) + _a16(R * (H + 8) * 2)
            + _a16(bufs * p.U * p.Hb * R * 4) + _a16(R * (p.NC + 8) * 2) + 2 * RING * 8)


def stream_tpw(gates: int, R: int) -> int:
    """8-row tiles a cell warp takes at ``R`` rows a cluster
    (``wide_mma_stream.cuh::ws_tpw``): up to ``STREAM_TPW``, but one for the
    GRU at R = 24 (two would leave its 128 registers short)."""
    return 1 if gates == 3 and R == 24 else min(R // 8, STREAM_TPW)


def stream_cells(H: int, gates: int, R: int) -> int:
    """Compute warps that hold cells at ``R`` rows a cluster
    (``wide_mma_stream.cuh::ws_cells``): one a unit group and up to
    :func:`stream_tpw` 8-row tiles (all ``STREAM_WARPS − 1`` compute warps
    take dh items)."""
    return plan(H, gates).Hb // UNIT_GROUP[gates] * -(-(R // 8) // stream_tpw(gates, R))


def stream_fits(H: int, gates: int = 4) -> bool:
    """Whether the streamed kernels take width ``H`` (padded to a multiple of
    32): a block's unit groups at most one a compute warp, and 8 rows a
    cluster with the ring and no resident chunk within ``SMEM_OPTIN``."""
    Hp = padded(H)
    return (stream_cells(Hp, gates, 8) < STREAM_WARPS
            and stream_smem_bytes(Hp, gates, 8, 0) <= SMEM_OPTIN)


@functools.cache
def stream_max_h(gates: int = 4) -> int:
    """The widest H of the streamed kernels' 64-k layout (1536 for the LSTM,
    1792 for the GRU: where the BPTT's block fits at 8 rows). The forward's
    route stops there (:func:`stream_fwd_max_h`: its block would fit further,
    but the forward takes the BPTT's packing); the BPTT takes its deep layout
    past it up to :func:`stream_bwd_max_h`."""
    H = max_h(gates)
    while H + K_GRANULE <= MAX_H and stream_fits(H + K_GRANULE, gates):
        H += K_GRANULE
    return H


def stream_fwd_max_h(gates: int = 4) -> int:
    """The widest H the streamed forwards take (:func:`stream_max_h`): past it
    the forward stays on the CUDA-core cluster kernel ("wide")."""
    return stream_max_h(gates)


def stream_bwd_max_h(gates: int = 4) -> int:
    """The widest H the streamed BPTTs take: ``DEEP_MAX_H`` (4096, the
    widest the port takes, ``wide_layout.MAX_H``), on the deep layout past
    :func:`stream_max_h`."""
    return DEEP_MAX_H


def stream_bwd_fits(H: int, gates: int = 4) -> bool:
    """Whether the streamed BPTTs take width ``H`` (padded to a multiple of
    32): the 64-k layout's widths (:func:`stream_fits`), then the deep
    layout's up to :func:`stream_bwd_max_h`."""
    return stream_fits(H, gates) or max_h(gates) < padded(H) <= stream_bwd_max_h(gates)


def stream_step_ps(H: int, NC: int, R: int, nstr: int) -> int:
    """The plan's step estimate in picoseconds (``ws_step_ps``)."""
    return STEP_PS + ROW_PS * nstr * NC + MAC_PS * (R * NC * H // 1024)


def deep_smem_bytes(H: int, gates: int, R: int, ring: int = RING) -> int:
    """A deep block's dynamic shared memory (``wide_mma_stream.cuh::wd_smem``):
    the ``dz`` tile (R × (NC + 8) bf16), the carry tile of summed dh partials
    (Hb × R f32) and ``ring`` slots, each a 32-k chunk tile (NC × 32 bf16),
    its R h_prev rows (``DEEP_HS`` bf16 each) and its two mbarriers."""
    p = plan(H, gates)
    slot = tile_bytes(p.NC, DEEP_CHUNK) + R * DEEP_HS * 2 + 2 * 8
    return _a16(R * (p.NC + 8) * 2) + p.Hb * R * 4 + ring * slot


def deep_ring(H: int, gates: int, R: int) -> int:
    """The deep layout's ring slots at ``R`` rows a cluster: as many as the
    block's room beside the ``dz`` and carry tiles holds, up to ``DEEP_MAX_RING`` (the
    bytes in flight from L2 are what a latency-bound stream's rate grows
    with)."""
    slot = deep_smem_bytes(H, gates, R, 1) - deep_smem_bytes(H, gates, R, 0)
    return min(DEEP_MAX_RING, (SMEM_OPTIN - deep_smem_bytes(H, gates, R, 0)) // slot)


def deep_ppw(H: int, gates: int, R: int) -> int:
    """Pairs a compute warp in the deep layout at ``R`` rows a cluster: the
    fewest that the ``STREAM_WARPS − 1`` compute warps cover the block's
    (unit group, 8-row tile) pairs with."""
    pairs = plan(H, gates).Hb // UNIT_GROUP[gates] * (R // 8)
    return -(-pairs // (STREAM_WARPS - 1))


def deep_kernel_ppw(H: int, gates: int, R: int) -> int | None:
    """The pairs a compute warp of the deep kernel a plan at ``R`` rows
    launches: the fewest from :func:`deep_ppw` up to ``DEEP_MAX_PPW`` whose
    kernel is instantiated (``STREAM_DEEP_KERNELS``); ``None`` if none is."""
    return next((n for n in range(deep_ppw(H, gates, R), DEEP_MAX_PPW[gates] + 1)
                 if (R // 8, n) in STREAM_DEEP_KERNELS[gates]), None)


def deep_scratch_bytes(H: int, gates: int, R: int) -> int:
    """Bytes of dh partials a deep cluster keeps in global memory: two
    buffers (by step parity) of U owners × U source blocks × Hb units × R
    rows, f32."""
    p = plan(H, gates)
    return 2 * p.U * p.U * p.Hb * R * 4


def deep_step_ps(H: int, NC: int, R: int) -> int:
    """The deep layout's step estimate in picoseconds (``wd_step_ps``): every
    chunk streamed."""
    return DEEP_STEP_PS + DEEP_ROW_PS * (H // DEEP_CHUNK) * NC + DEEP_MAC_PS * (R * NC * H // 1024)


def stream_plan(B: int, H: int, gates: int, clusters) -> StreamPlan:
    """The launcher's plan for ``B`` rows at width ``H`` (a multiple of 32)
    when the card holds ``clusters`` clusters at once (an int, or a function
    of the block's shared memory; ``percival_*_bwd_wide_mma_stream_plan``
    reports both). Up to :func:`stream_max_h`, the 64-k layout: among R = 8,
    16, 24 whose cells fit the 15 compute warps (:func:`stream_cells`) and
    that fit ``SMEM_OPTIN`` with the ring, a second buffer of partial slots
    where it fits (one cluster barrier a step, not two), then as many chunks
    resident as fit (all but one at most). Past it up to
    :func:`stream_bwd_max_h`, the deep layout: among R = 8, 16, 24 with an
    instantiated kernel of as many pairs a compute warp as they need or more
    (:func:`deep_kernel_ppw`) and whose block fits ``SMEM_OPTIN`` with
    ``RING`` slots (:func:`deep_smem_bytes`), the ring as deep as fits
    (:func:`deep_ring`). Either way the least ``waves ×``
    step estimate, then the smallest R."""
    p = plan(H, gates)
    deep = not stream_fits(H, gates)
    if deep and H > stream_bwd_max_h(gates):
        raise ValueError(f"no rows a cluster fit the streamed tensor-core wide {CELLS[gates]} "
                         f"at H={H}")
    nch = chunks(H)
    best, best_cost = None, None
    for R in range(8, STREAM_MAX_ROWS + 1, 8):
        if deep:
            ppw = deep_kernel_ppw(H, gates, R)
            if ppw is None or deep_smem_bytes(H, gates, R) > SMEM_OPTIN:
                continue
            ring = deep_ring(H, gates, R)
            cand = (0, H // DEEP_CHUNK, 0, deep_smem_bytes(H, gates, R, ring), DEEP_CHUNK, ppw,
                    deep_scratch_bytes(H, gates, R), ring)
            step = deep_step_ps(H, p.NC, R)
        else:
            base = stream_smem_bytes(H, gates, R, 0)
            if stream_cells(H, gates, R) >= STREAM_WARPS or base > SMEM_OPTIN:
                continue
            dbuf = int(stream_smem_bytes(H, gates, R, 0, 2) <= SMEM_OPTIN)
            room = SMEM_OPTIN - stream_smem_bytes(H, gates, R, 0, 1 + dbuf)
            nres = min(nch - 1, room // tile_bytes(p.NC))
            smem = stream_smem_bytes(H, gates, R, nres, 1 + dbuf)
            cand = (nres, nch - nres, dbuf, smem, CHUNK, 0, 0, RING)
            step = stream_step_ps(H, p.NC, R, nch - nres)
        c = clusters(cand[3]) if callable(clusters) else clusters
        if c < 1:
            continue
        waves = -(-2 * -(-B // R) // c)
        cost = waves * step
        if best is None or cost < best_cost:
            nres, nstr, dbuf, smem, chunk, ppw, scratch, ring = cand
            best = StreamPlan(*p, R, nres, nstr, c, waves, dbuf, smem, chunk, ppw, scratch, ring)
            best_cost = cost
    if best is None:
        raise ValueError(f"no rows a cluster fit the streamed tensor-core wide {CELLS[gates]} "
                         f"at H={H}")
    return best


def tile_index(NC: int, chunk: int = CHUNK) -> torch.Tensor:
    """``(NC, chunk)`` int64: where element ``(p, k)`` of a chunk (packed row
    ``p``, its k ``k``) lies in the chunk's tile of ``NC × chunk`` elements,
    as the kernels address it (row ``p`` at ``chunk·p``, its 16-byte unit
    ``k // 8`` swizzled: at ``u ^ (p % 8)`` in a 64-k row, ``u ^ ((p % 8) >> 1)``
    in a 32-k one; ``wide_mma_stream.cuh::ws_unit``)."""
    p = torch.arange(NC)
    k = torch.arange(chunk)
    r8 = p % 8 if chunk == CHUNK else (p % 8) // 2
    unit = (k // 8)[None, :] ^ r8[:, None]
    return p[:, None] * chunk + unit * 8 + (k % 8)[None, :]


def pack_wh_stream(wh: torch.Tensor, p: Plan, chunk: int = CHUNK) -> torch.Tensor:
    """``(H, gates·H)`` recurrent kernel → ``(U, chunks, NC, chunk)``
    contiguous: :func:`pack_wh`'s slices cut into chunks of ``chunk`` k (64,
    the last one zero-padded when H ≡ 32 mod 64; or the deep layout's 32),
    each chunk's tile laid out as the kernels read it (:func:`tile_index`), so
    that one contiguous copy moves a chunk into shared memory."""
    wp = pack_wh(wh, p)  # (U, NC, H)
    H = wp.shape[2]
    nch = chunks(H, chunk)
    wp = torch.nn.functional.pad(wp, (0, nch * chunk - H)).view(p.U, p.NC, nch, chunk)
    wp = wp.permute(0, 2, 1, 3).reshape(p.U, nch, p.NC * chunk)
    out = torch.empty_like(wp)
    out[:, :, _tile_index_on(p.NC, chunk, wh.device).flatten()] = wp
    return out.view(p.U, nch, p.NC, chunk)


def unpack_wh_stream(ws: torch.Tensor, p: Plan, H: int) -> torch.Tensor:
    """Inverse of :func:`pack_wh_stream` (at the chunk width of ``ws``):
    ``(U, chunks, NC, chunk)`` → the ``(U, NC, H)`` slices of :func:`pack_wh`."""
    nch, chunk = ws.shape[1], ws.shape[3]
    flat = ws.reshape(p.U, nch, p.NC * chunk)[:, :, tile_index(p.NC, chunk).flatten()]
    return flat.view(p.U, nch, p.NC, chunk).permute(0, 2, 1, 3).reshape(p.U, p.NC, -1)[..., :H]


@functools.lru_cache(maxsize=None)
def _tile_index_on(NC: int, chunk: int, device: torch.device) -> torch.Tensor:
    return tile_index(NC, chunk).to(device)


def _stream_tiles(ws: torch.Tensor, p: Plan, b: int) -> torch.Tensor:
    """Block ``b``'s chunks read through the kernels' addressing:
    ``(chunks, NC, chunk)`` with element ``(c, p, k)`` taken from the tile
    at :func:`tile_index` ``(p, k)``."""
    chunk = ws.shape[3]
    idx = tile_index(p.NC, chunk).flatten()
    return ws[b].reshape(ws.shape[1], -1)[:, idx].view(ws.shape[1], p.NC, chunk)


def replay_stream_recompute(h: torch.Tensor, ws: torch.Tensor, p: Plan,
                            split: bool = False) -> torch.Tensor:
    """``h (R, H) · W_h`` → ``(R, gates·H)`` as the streamed kernels compute
    it from the chunk tiles of :func:`pack_wh_stream`: block ``b``'s m16
    tiles of packed rows against the 8-row tiles of ``h``, chunk by chunk and
    within a chunk k-step by k-step, in order (``replay_recompute``'s sums);
    ``split``: the even and the odd k-steps each summed in order apart, then
    added (the forwards' order at one pair a warp, ``wsf_product``)."""
    R, H = h.shape
    cols = columns(H, p)
    z = h.new_zeros((R, (p.NC // p.Hb) * H))
    chunk = ws.shape[3]
    for b in range(p.U):
        tiles = _stream_tiles(ws, p, b)
        acc = [h.new_zeros((p.NC, R)), h.new_zeros((p.NC, R))]
        for kk in range(H // 16):
            c, kl = divmod(16 * kk, chunk)
            part = kk % 2 if split else 0
            acc[part] = acc[part] + tiles[c, :, kl:kl + 16] @ h[:, 16 * kk:16 * kk + 16].t()
        acc = acc[0] + acc[1] if split else acc[0]
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[ok].t()
    return z


def replay_stream_dh(dz: torch.Tensor, ws: torch.Tensor, p: Plan) -> torch.Tensor:
    """``dz (R, gates·H) · W_hᵀ`` → ``(R, H)`` as the streamed kernels compute
    it: each unit from block ``b``'s chunk tiles (read through the kernels'
    addressing, either chunk width), K = the block's packed rows in 16-row
    k-steps in order, the ``U`` partials of a unit added in block order by
    its owner (``replay_dh``'s sums: a unit's chunk only says where its
    column lies)."""
    R, G = dz.shape
    H = G // (p.NC // p.Hb)
    cols = columns(H, p)
    dh = dz.new_zeros((R, H))
    for b in range(p.U):
        w = _stream_tiles(ws, p, b).permute(1, 0, 2).reshape(p.NC, -1)[:, :H]  # (NC, H)
        dz_b = torch.where(cols[b] >= 0, dz[:, cols[b].clamp(min=0)], 0.0)  # (R, NC)
        part = dz.new_zeros((H, R))
        for kk in range(p.NC // 16):
            part = part + w[16 * kk:16 * kk + 16].t() @ dz_b[:, 16 * kk:16 * kk + 16].t()
        dh = dh + part.t()
    return dh


# ---- the streamed forwards (route "wide_mma_stream", the forward half) -----
#
# csrc/bilstm_fwd_wide_mma_stream.cu / csrc/bigru_fwd_wide_mma_stream.cu run
# the recompute's product alone, zᵀ = W_hᵀ slice · round(h)ᵀ, on the same
# chunk tiles (pack_wh_stream: one packing for both passes), chunk by chunk
# in order (replay_stream_recompute's sums), then the gate math and the
# all-gather of round(h) of "wide_mma"'s forwards. With no dz tile and no
# partial slots a block holds up to STREAM_FWD_MAX_ROWS rows; its 15 compute
# warps take the block's (unit group, 8-row tile) pairs PPW at a time in
# unit-group-major order (stream_fwd_pairs).

STREAM_FWD_MAX_ROWS = 64  # batch rows a cluster
STREAM_FWD_MAX_PPW = {4: 4, 3: 3}  # pairs a compute warp at most (the kernels instantiated)
# the forward's step estimate (ps; wide_mma_stream.cuh::wsf_step_ps): fixed, a
# second cluster barrier with one h buffer, a streamed packed row of a chunk
# (128 bytes from L2; the fit's 1970 ps over its ring's depth, at RING), and
# R·NC·H / 1024 multiply-adds; fitted by least squares to the 112 steps that
# fwd_step_breakdown.py --wide --stream --sweep timed on an H100 SXM (PERF.md)
FWD_STEP_PS, FWD_SYNC_PS, FWD_ROW_PS, FWD_MAC_PS = 5_329_000, 1_396_000, 657, 1807


class StreamFwdPlan(NamedTuple):
    U: int  # blocks in a direction's cluster
    Hb: int  # units a block
    NC: int  # packed W_hᵀ rows a block
    R: int  # batch rows a cluster, a multiple of 8
    PPW: int  # (unit group, 8-row tile) pairs a compute warp
    nres: int  # chunks resident in shared memory (the last ones)
    nstr: int  # chunks streamed every step (the first ones)
    clusters: int  # clusters the card holds at once
    waves: int  # ceil(2·ceil(B / R) / clusters)
    dbuf: int  # 1: two h buffers, one cluster barrier a step
    smem: int  # dynamic shared memory a block, bytes


def stream_fwd_ppw(H: int, gates: int, R: int) -> int:
    """Pairs a compute warp at ``R`` rows a cluster (``wsf_ppw``): the fewest
    that the ``STREAM_WARPS − 1`` compute warps cover the block's
    (unit group, 8-row tile) pairs with."""
    nug = plan(H, gates).Hb // UNIT_GROUP[gates]
    return -(-nug * (R // 8) // (STREAM_WARPS - 1))


def stream_fwd_pairs(H: int, gates: int, R: int, warp: int) -> list:
    """The ``(unit group, 8-row tile)`` pairs compute warp ``warp`` takes at
    ``R`` rows a cluster: pairs ``PPW·warp …`` of the block's, unit-group-major."""
    nug, nt8 = plan(H, gates).Hb // UNIT_GROUP[gates], R // 8
    ppw = stream_fwd_ppw(H, gates, R)
    return [divmod(q, nt8) for q in range(ppw * warp, min(ppw * (warp + 1), nug * nt8))]


def stream_fwd_smem_bytes(H: int, gates: int, R: int, nres: int, bufs: int = 1) -> int:
    """A streamed forward block's dynamic shared memory (``wsf_smem``): the
    ring's ``RING`` chunk tiles and ``nres`` resident ones, ``bufs`` ``h``
    tiles (R × (H + 8) bf16), the warps' staging tiles (15 warps × PPW pairs
    × 8 rows × a unit group's units, bf16) and the ring's ``2·RING``
    mbarriers."""
    p = plan(H, gates)
    stage = (STREAM_WARPS - 1) * stream_fwd_ppw(H, gates, R) * 8 * UNIT_GROUP[gates] * 2
    return (RING + nres) * tile_bytes(p.NC) + bufs * _a16(R * (H + 8) * 2) + stage + 2 * RING * 8


def stream_fwd_step_ps(H: int, NC: int, R: int, nstr: int, dbuf: int) -> int:
    """The forward plan's step estimate in picoseconds (``wsf_step_ps``)."""
    return (FWD_STEP_PS + (0 if dbuf else FWD_SYNC_PS) + FWD_ROW_PS * nstr * NC
            + FWD_MAC_PS * (R * NC * H // 1024))


def stream_fwd_plan(B: int, H: int, gates: int, clusters, rows: int = 0) -> StreamFwdPlan:
    """The forward launcher's plan for ``B`` rows at width ``H`` (a multiple
    of 32) when the card holds ``clusters`` clusters at once (an int, or a
    function of the block's shared memory;
    ``percival_*_fwd_wide_mma_stream_plan`` reports both): among R = 8 … 64
    whose pairs fall at most ``STREAM_FWD_MAX_PPW`` to a compute warp and
    that fit ``SMEM_OPTIN`` with the ring and one ``h`` buffer, a second
    ``h`` buffer where it fits (one cluster barrier a step, not two), then
    as many chunks resident as the room holds, at most all but one (a
    deeper ring streams more bytes a step: it measured slower at every
    (H, B) timed, ``fwd_step_breakdown.py --wide --stream --sweep``,
    PERF.md); the least ``waves × stream_fwd_step_ps``, then the smallest
    R. ``rows > 0`` takes that R alone (a measurement's override)."""
    p = plan(H, gates)
    nch = chunks(H)
    best, best_cost = None, None
    for R in range(8, STREAM_FWD_MAX_ROWS + 1, 8):
        if rows and R != rows or p.Hb // UNIT_GROUP[gates] > STREAM_WARPS - 1:
            continue
        if (stream_fwd_ppw(H, gates, R) > STREAM_FWD_MAX_PPW[gates]
                or stream_fwd_smem_bytes(H, gates, R, 0) > SMEM_OPTIN):
            continue
        dbuf = int(stream_fwd_smem_bytes(H, gates, R, 0, 2) <= SMEM_OPTIN)
        room = (SMEM_OPTIN - stream_fwd_smem_bytes(H, gates, R, 0, 1 + dbuf)) // tile_bytes(p.NC)
        nres = min(room, nch - 1)
        smem = stream_fwd_smem_bytes(H, gates, R, nres, 1 + dbuf)
        c = clusters(smem) if callable(clusters) else clusters
        if c < 1:
            continue
        waves = -(-2 * -(-B // R) // c)
        cost = waves * stream_fwd_step_ps(H, p.NC, R, nch - nres, dbuf)
        if best is None or cost < best_cost:
            best = StreamFwdPlan(*p, R, stream_fwd_ppw(H, gates, R), nres, nch - nres, c, waves,
                                 dbuf, smem)
            best_cost = cost
    if best is None:
        raise ValueError(f"no rows a cluster fit the streamed tensor-core wide {CELLS[gates]} "
                         f"forward at H={H}")
    return best


def replay_stream_fwd(gx: torch.Tensor, ws: torch.Tensor, p: Plan, bn: torch.Tensor = None,
                      reverse: bool = False, dtype: torch.dtype = torch.float32,
                      split: bool = False):
    """One direction's forward as the streamed kernels compute it: ``gx
    (T, B, gates·H)`` (f32 values), the chunk tiles ``ws`` of
    :func:`pack_wh_stream` and, for the GRU, ``b_hn (H,)`` → ``y`` (and the
    LSTM's cells ``c``) ``(T, B, H)`` in f32, ``reverse`` walking t = T−1 … 0.
    Each step's product is :func:`replay_stream_recompute` of ``round(h)``
    (``dtype``'s rounding, none for f32; ``split``: the even and odd k-steps
    apart, as a plan of one pair a compute warp sums them), the gate math
    runs in f32 on ``gx +`` the product, the carries stay in f32, and ``y`` /
    ``c`` are rounded to ``dtype`` as the kernels store them."""
    T, B, G = gx.shape
    gates = p.NC // p.Hb
    H = G // gates
    rnd = (lambda t: t) if dtype == torch.float32 else (lambda t: t.to(dtype).float())  # noqa: E731
    h, c = gx.new_zeros((B, H)), gx.new_zeros((B, H))
    ys, cs = [], []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = replay_stream_recompute(rnd(h), ws, p, split)
        if gates == 4:
            z = gx[t] + gh
            i, f = torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H])
            g, o = torch.tanh(z[:, 2 * H:3 * H]), torch.sigmoid(z[:, 3 * H:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            cs.append(rnd(c))
        else:
            r = torch.sigmoid(gx[t][:, :H] + gh[:, :H])
            zg = torch.sigmoid(gx[t][:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gx[t][:, 2 * H:] + r * (gh[:, 2 * H:] + bn))
            h = (1 - zg) * n + zg * h
        ys.append(rnd(h))
    if reverse:
        ys.reverse()
        cs.reverse()
    y = torch.stack(ys)
    return (y, torch.stack(cs)) if gates == 4 else y
