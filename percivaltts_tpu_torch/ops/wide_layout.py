"""The wide route of the recurrent kernels: how ``csrc/bilstm_fwd_wide.cu``,
``csrc/bilstm_bwd_wide.cu``, ``csrc/bigru_fwd_wide.cu`` and
``csrc/bigru_bwd_wide.cu`` split one direction's units over a cluster of
blocks, and the per-block packing of ``W_h`` they read.

A direction's recurrent kernel does not fit one SM above H = 256 (LSTM) or
320 (GRU): bf16 W_h at H = 512 is 2 MiB (1.5 MiB), and a block may use
227 KB of shared memory. So each direction and tile of batch rows runs on a
thread-block cluster of ``U`` blocks (:func:`plan`): block ``b`` owns units
``b·Hb … b·Hb + Hb − 1`` (fewer in the last block) with all ``gates`` gates
of each (4 for the LSTM, 3 for the GRU), so the c/h update (the GRU's
``r ⊙ (h·W_hn + b_hn)`` and ``(1 − z)·n + z·h``) stays in the block. Its
``NC = gates·Hb`` gate columns are gate-major, ``c = g·Hb + u`` ↔ column
``g·H + b·Hb + u`` of ``W_h`` (:func:`columns`), and the wrapper packs them
per block (:func:`pack_wh`): ``(U, H, NC)``, zero where a column lies past
H.

Every step is an exchange inside the cluster:

- forward, and the BPTT's gate recompute: block ``b``'s ``NT = NC·KS``
  threads split the product ``h · W_h[:, its columns]`` into ``KS`` slices
  of ``k`` (thread ``t`` owns column ``t % NC`` and slice ``t // NC``); the
  slices' partial sums meet in shared memory (:func:`replay_product`). The
  forward then writes its units' ``round_dt(h)`` into every block's shared
  memory (distributed shared memory) and the cluster synchronises once;
- BPTT: ``dh = dz · W_hᵀ`` sums over all ``gates·H`` columns, which the
  blocks share out; block ``b`` sums its own ``NC`` columns for every ``k``
  and writes row ``k``'s partial into the block that owns unit ``k``, which
  adds the ``U`` partials after the cluster's barrier (:func:`replay_dh`).

``NC`` is a whole number of warps: ``Hb`` is a multiple of 8 for the LSTM
and of 32 for the GRU (``GRANULE``: 3·Hb is a multiple of 32 only when Hb
is). ``U`` is at most 16 (``MAX_CLUSTER``, the H100's non-portable cluster
size), and ``NT`` at most 1024 threads for the LSTM, 768 for the GRU
(``THREADS``: its kernels are built for 768, which leaves 80 registers a
thread), so both routes take ``1 <= H <= 4096`` (``MAX_H``, :func:`max_h`).
The kernels choose their batch rows per cluster and whether ``W_h`` stays
in shared memory on the card; they recompute ``NC``, ``KS`` and ``NT`` with
these formulas (``percival_{bilstm,bigru}_{fwd,bwd}_wide_plan`` returns
them; ``chip_smoke.py`` holds them against :func:`plan`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

MAX_CLUSTER = 16  # blocks a cluster (cudaFuncAttributeNonPortableClusterSizeAllowed)
UNIT_GRANULE = 8  # LSTM units a block, in multiples of: 4·Hb a whole number of warps
MAX_THREADS = 1024
MAX_KSLICES = 32
# by gate count (4: LSTM, 3: GRU): units a block in multiples of, threads a block at most
GRANULE = {4: UNIT_GRANULE, 3: 32}
THREADS = {4: MAX_THREADS, 3: 768}
CELLS = {4: "BiLSTM", 3: "BiGRU"}


def max_h(gates: int = 4) -> int:
    """The widest H of the route: 16 blocks of the most units whose
    ``gates`` columns fit the threads of a block (4096 for both cells)."""
    g = GRANULE[gates]
    return MAX_CLUSTER * (THREADS[gates] // gates // g * g)


MAX_H = max_h(4)  # 16 blocks of 256 units: 4·Hb <= 1024 threads
GRU_MAX_H = max_h(3)  # 16 blocks of 256 units: 3·Hb <= 768 threads


class Plan(NamedTuple):
    U: int  # blocks in a direction's cluster
    Hb: int  # units a block (the last block may hold fewer)
    NC: int  # gate columns a block, gates·Hb
    KS: int  # slices of k in the product
    NT: int  # threads a block, NC·KS


def plan(H: int, gates: int = 4) -> Plan:
    """The cluster split for width ``H`` of a cell with ``gates`` gates (4:
    LSTM, 3: GRU); raises ``ValueError`` outside ``1 <= H <= max_h(gates)``."""
    if gates not in GRANULE:
        raise ValueError(f"gates must be one of {tuple(GRANULE)}, got {gates}")
    limit = max_h(gates)
    if not 1 <= H <= limit:
        raise ValueError(f"the wide CUDA {CELLS[gates]} takes 1 <= H <= {limit}, got H={H}")
    Hb = -(-H // MAX_CLUSTER)
    Hb = -(-Hb // GRANULE[gates]) * GRANULE[gates]
    NC = gates * Hb
    KS = 1
    while KS < MAX_KSLICES and 2 * KS * NC <= THREADS[gates] and 2 * KS <= H:
        KS *= 2
    return Plan(-(-H // Hb), Hb, NC, KS, NC * KS)


def gates_of(p: Plan) -> int:
    return p.NC // p.Hb


def slice_length(H: int, KS: int) -> int:
    """k a product thread sums: ``ceil(H / KS)`` rounded up to a multiple of 4."""
    KL = -(-H // KS)
    return -(-KL // 4) * 4


def columns(H: int, p: Plan) -> torch.Tensor:
    """``(U, NC)`` int64: the column of ``W_h`` (``gate·H + unit``) that
    block ``b``'s local column ``c`` holds, −1 past the last unit."""
    b = torch.arange(p.U)[:, None]
    c = torch.arange(p.NC)[None, :]
    g, u = c // p.Hb, c % p.Hb
    unit = b * p.Hb + u
    return torch.where(unit < H, g * H + unit, -1)


@functools.lru_cache(maxsize=None)
def _columns_on(H: int, gates: int, device: torch.device) -> torch.Tensor:
    # made once a width and device: a copy to the card from pageable memory
    # would wait for the stream at every launch
    return columns(H, plan(H, gates)).to(device)


def pack_wh(wh: torch.Tensor, p: Plan) -> torch.Tensor:
    """``(H, gates·H)`` recurrent kernel → ``(U, H, NC)`` contiguous, block
    ``b``'s columns in :func:`columns` order, zero past the last unit."""
    H, gates = wh.shape[0], gates_of(p)
    if p != plan(H, gates) or wh.shape[1] != gates * H:
        raise ValueError(f"{p} is not the plan of a {tuple(wh.shape)} recurrent kernel")
    cols = _columns_on(H, gates, wh.device)
    packed = wh[:, cols.clamp(min=0)].permute(1, 0, 2)  # (U, H, NC)
    return packed.masked_fill((cols < 0)[:, None, :], 0).contiguous()


def replay_product(h: torch.Tensor, wp: torch.Tensor, p: Plan) -> torch.Tensor:
    """``h (R, H) · W_h`` → ``(R, gates·H)`` as the blocks compute it: block
    ``b``'s thread for column ``c`` and k-slice ``s`` sums
    ``k = s·KL … min(H, (s+1)·KL) − 1`` (``KL = ceil(H / KS)`` rounded up to
    a multiple of 4: the kernels read h four k at a time), and the ``KS``
    partials of a column are added in slice order."""
    R, H = h.shape
    KL = slice_length(H, p.KS)
    z = h.new_zeros((R, gates_of(p) * H))
    cols = columns(H, p)
    for b in range(p.U):
        acc = h.new_zeros((R, p.NC))
        for s in range(p.KS):
            k0, k1 = min(H, s * KL), min(H, (s + 1) * KL)
            acc = acc + h[:, k0:k1] @ wp[b, k0:k1]
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[:, ok]
    return z


def replay_dh(dz: torch.Tensor, wp: torch.Tensor, p: Plan) -> torch.Tensor:
    """``dz (R, gates·H) · W_hᵀ`` → ``(R, H)`` as the BPTT's blocks compute it:
    each block's partial over its own ``NC`` columns for every ``k``, the
    ``U`` partials of unit ``k`` added in block order by its owner."""
    R, G = dz.shape
    H = G // gates_of(p)
    cols = columns(H, p)
    dh = dz.new_zeros((R, H))
    for b in range(p.U):
        dz_b = torch.where(cols[b] >= 0, dz[:, cols[b].clamp(min=0)], 0.0)  # (R, NC)
        dh = dh + dz_b @ wp[b].T
    return dh
