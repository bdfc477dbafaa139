"""The f32 kernels at the widths one block held before (route ``"narrow_f32"``):
which widths the BPTTs ``csrc/bilstm_bwd_narrow_f32.cu`` /
``csrc/bigru_bwd_narrow_f32.cu`` and the forwards
``csrc/bilstm_fwd_narrow_f32.cu`` / ``csrc/bigru_fwd_narrow_f32.cu`` take,
how they split a direction's units over a cluster and pack ``W_h``, the
plans of rows and blocks they choose, and the order in which they sum,
replayed in torch.

Each direction and tile of ``R`` batch rows runs on a thread-block cluster
of ``U`` blocks; block ``b`` owns units ``b·Hb …`` (``Hb`` a multiple of 8,
the last block may hold fewer) with all ``gates`` gates of each
(:func:`split`), ``NC = gates·Hb`` gate columns, gate-major as in the
``"wide"`` route (``wide_layout.columns``), padded with zero columns to
``NCP``, a multiple of 32 (:func:`pack_wh`: ``(U, H, NCP)``). The block's
f32 slice stays in its shared memory for the whole sequence, beside the
rows (:func:`smem_bytes`), so a step reads it once for the cluster's rows,
for both products.

The plan (:func:`plan`, the launchers' ``narrow_f32_plan``): every split of
``BLOCKS`` (each distinct ``Hb`` once) and ``R`` of ``ROWS`` whose block fits
``SMEM_OPTIN`` and gives each thread at most 2 (row, unit) pairs (``Hb`` at most
256), the least estimated time, ``waves ×`` :func:`step_cost`; waves count
the clusters of ``U`` blocks the card holds at once, which only the card says
(``percival_*_bwd_narrow_f32_plan`` reports them).

The forwards (``narrow_f32_fwd.cuh``) take the same split and packing with
their own plan (:func:`fwd_plan`: no dz rows or partial slots in a block,
:func:`fwd_smem_bytes`; one product a step, :func:`fwd_step_cost`), and
sum their product as the BPTT's recompute (:func:`replay_fwd`). Where
:func:`reg_fits`, the plan may instead hold all of W_h in the registers of
one block of ``4H`` threads (``resident``, R = 1 or 2,
:func:`reg_step_cost`), which sums in the same order: thread (unit u, lane
q) takes the k with ``(k % 16) // 4 == q`` of all of u's gates.

Both products run on CUDA cores in f32 (``narrow_f32_common.cuh``), summed as
:func:`replay_recompute` and :func:`replay_dh` replay: the recompute of a
column in four lanes, lane ``j`` taking the ``k`` with ``(k % 16) // 4 ==
j``, added ``(s0 + s1) + (s2 + s3)``; a block's ``dh`` partial of a row of
``k`` in four lanes, lane ``i`` taking the columns with ``(c % 16) // 4 ==
i``, added ``(a0 + a1) + (a2 + a3)``; the owner of unit ``k`` adds the ``U``
block partials in block order (the GRU after its own ``dh·z``)
(:func:`replay_bptt`). Widths not a multiple of 8 are zero-padded
(``ops/lstm_cuda.py::at_width``, exact).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from percivaltts_tpu_torch.ops import wide_f32_layout, wide_layout

K_GRANULE = 8  # H and Hb are whole numbers of these
COLS = 32  # NC is padded to a multiple of these (NCP)
BLOCKS = (1, 2, 4, 8)  # cluster sizes the plan tries (16 measured no faster)
ROWS = (2, 4, 8, 16)  # batch rows a cluster
THREADS = 512
MAX_PAIRS = 2  # (row, unit) pairs a thread in the gate phase
MAX_HB = 256  # units a block
MAX_CLUSTER = 16
STEP, PER_BLOCK = 3100, 60  # the plan's step estimate, cycles (step_cost)
# the forward's (fwd_step_cost): the gate phase and loop, the cluster
# barrier and h writes into other blocks (U > 1)
FWD_STEP, FWD_CLUSTER = 1756, 764
# the forward kernel that holds all of W_h in registers: words a thread, its
# rows, the shared memory a block asks for (so that no two share an SM), its
# step estimate's fixed part, cycles (reg_step_cost)
REG_MAX_WORDS, REG_ROWS, REG_SMEM, REG_STEP = 96, (1, 2), 116 * 1024, 989
SMEM_OPTIN = wide_f32_layout.SMEM_OPTIN
# the widest H of the route: the one-block kernels' (ops/mma_layout.py)
MAX_H = {4: 256, 3: 320}


class Split(NamedTuple):
    U: int  # blocks in a direction's cluster
    Hb: int  # units a block (the last block may hold fewer)
    NC: int  # gate columns a block, gates·Hb
    NCP: int  # NC padded to a multiple of 32


class Plan(NamedTuple):
    U: int
    Hb: int
    NC: int
    NCP: int
    R: int  # batch rows a cluster
    clusters: int  # clusters of U blocks the card holds at once
    waves: int  # ceil(2·ceil(B / R) / clusters)
    smem: int  # dynamic shared memory a block, bytes
    resident: int = 0  # the forward's: 1 when W_h stays in registers (U = 1, 4H threads)


def padded(H: int) -> int:
    """The width the kernels run ``H`` at: the next multiple of 8."""
    return -(-H // K_GRANULE) * K_GRANULE


def split(H: int, blocks: int, gates: int) -> Split:
    """The split of ``H`` units over at most ``blocks`` blocks: ``Hb =
    ceil(H / blocks)`` rounded up to a multiple of 8, ``U = ceil(H / Hb)``."""
    per_block = -(-H // blocks)
    Hb = -(-per_block // K_GRANULE) * K_GRANULE
    NC = gates * Hb
    return Split(-(-H // Hb), Hb, NC, -(-NC // COLS) * COLS)


def smem_bytes(H: int, s: Split, R: int) -> int:
    """A block's dynamic shared memory (``narrow_f32_common.cuh::nf_smem``):
    the W_h slice ``H × (NCP + 4)``, two buffers of ``h_prev`` rows
    ``R × H``, the z and dz rows ``R × (NCP + 4)`` each, two buffers of
    partial slots ``U × R × Hb``, and the GRU's ``dn_pre`` rows ``R × Hb``,
    all f32."""
    ws = s.NCP + 4
    extra = 1 if s.NC == 3 * s.Hb else 0
    return 4 * (H * ws + 2 * R * H + 2 * R * ws + (2 * s.U + extra) * R * s.Hb)


def fwd_smem_bytes(H: int, s: Split, R: int) -> int:
    """A forward block's dynamic shared memory
    (``narrow_f32_common.cuh::nf_fwd_smem``): the W_h slice
    ``H × (NCP + 4)``, two buffers of h rows ``R × H`` and the z rows
    ``R × (NCP + 4)``, all f32."""
    ws = s.NCP + 4
    return 4 * (H * ws + 2 * R * H + R * ws)


def step_cost(H: int, s: Split, R: int) -> int:
    """The plan's estimate of a step, in cycles, fitted to steps the H100
    timed over every split and R at H = 64, 128 and 256 / 320: the gate
    phase and the barriers (``STEP``), the partial slots a pair adds
    (``PER_BLOCK·U``), the reads of the W_h slice, once a tile of 4 rows
    (``H·NCP·ceil(R / 4) / 16``), and both products' FMAs (``R·H·NCP / 64``)."""
    w = H * s.NCP
    return STEP + PER_BLOCK * s.U + w * (-(-R // 4)) // 16 + R * w // 64


def fwd_step_cost(H: int, s: Split, R: int) -> int:
    """The forward plan's estimate of a step, in cycles, fitted to the steps
    the H100 timed over every split and R at H = 64, 96, 128 and 256 / 320
    (``tools/fwd_step_breakdown.py --simt --f32 --grid``): the gate phase and
    the loop (``FWD_STEP``), the cluster barrier and the h writes into other
    blocks where ``U > 1`` (``FWD_CLUSTER``), and the product,
    ``R·H·NCP / 65`` (the W_h slice's reads cost no more beside it)."""
    return FWD_STEP + (FWD_CLUSTER if s.U > 1 else 0) + R * H * s.NCP // 65


def reg_fits(H: int, gates: int) -> bool:
    """Whether the forward may hold all of ``W_h`` in registers
    (``narrow_f32_fwd.cuh::nf_reg_fits``): H a multiple of 16 up to 128 and
    ``gates·H / 4 <= REG_MAX_WORDS`` words a thread (the GRU up to 128, the
    LSTM up to 96)."""
    return H % 16 == 0 and H <= 128 and gates * H <= 4 * REG_MAX_WORDS


def reg_step_cost(H: int, gates: int, R: int) -> int:
    """The resident kernel's step estimate, in cycles, fitted as
    :func:`fwd_step_cost` was: ``REG_STEP`` for the gate phase, the shuffles
    and the loop, then the product, ``gates·H·H·R / 71``."""
    return REG_STEP + gates * H * H * R // 71


def candidates(H: int, gates: int, blocks: int = 0, rows: int = 0, fwd: bool = False) -> list:
    """``[(Split, R, smem)]`` in the plan's order that fit a block: each
    distinct split of ``BLOCKS`` (or of ``blocks`` alone), each R of ``ROWS``
    (or ``rows`` alone); the forward's blocks (``fwd``) by
    :func:`fwd_smem_bytes`."""
    out, last = [], 0
    for b in (blocks,) if blocks else BLOCKS:
        s = split(H, b, gates)
        if s.Hb == last:
            continue
        last = s.Hb
        for R in ROWS:
            if rows and R != rows:
                continue
            smem = (fwd_smem_bytes if fwd else smem_bytes)(H, s, R)
            if (s.U <= MAX_CLUSTER and s.Hb <= MAX_HB and R * s.Hb <= MAX_PAIRS * THREADS
                    and smem <= SMEM_OPTIN):
                out.append((s, R, smem))
    return out


def _least(B: int, H: int, gates: int, clusters, blocks: int, rows: int, fwd: bool) -> Plan:
    best, best_cost = None, None
    cost_of = fwd_step_cost if fwd else step_cost
    for s, R, smem in candidates(H, gates, blocks, rows, fwd):
        c = clusters[s.U]
        if c < 1:
            continue
        waves = -(-2 * -(-B // R) // c)
        cost = waves * cost_of(H, s, R)
        if best_cost is None or cost < best_cost:
            best, best_cost = Plan(*s, R, c, waves, smem), cost
    if best is None:
        raise ValueError(f"no f32 narrow {'forward' if fwd else 'BPTT'} plan fits B={B} H={H}")
    return best


def plan(B: int, H: int, gates: int, clusters, blocks: int = 0, rows: int = 0) -> Plan:
    """The BPTT launchers' choice for ``B`` rows at width ``H`` (a multiple
    of 8) when the card holds ``clusters[U]`` clusters of ``U`` blocks at
    once: the least ``waves × step_cost``, the first in :func:`candidates`'
    order on a tie; ``blocks`` / ``rows`` as the launchers' overrides."""
    return _least(B, H, gates, clusters, blocks, rows, fwd=False)


def fwd_plan(B: int, H: int, gates: int, clusters, blocks: int = 0, rows: int = 0,
             resident: int = -1) -> Plan:
    """The forward launchers' choice: as :func:`plan` with the forward's
    blocks (:func:`fwd_smem_bytes`) and step (:func:`fwd_step_cost`), and,
    where :func:`reg_fits` and ``blocks <= 1``, the resident kernel at each R
    of ``REG_ROWS`` whose blocks fit one wave (``clusters["resident"]`` at
    once; a second wave measured slower than the shared-memory plans at
    B = 160) if its :func:`reg_step_cost` is strictly less; ``resident`` 0 /
    1 takes only that kind (-1: either)."""
    best, best_cost = None, None
    if resident != 1:
        try:
            best = _least(B, H, gates, clusters, blocks, rows, fwd=True)
            best_cost = best.waves * fwd_step_cost(H, Split(*best[:4]), best.R)
        except ValueError:
            pass
    if resident != 0 and blocks <= 1 and reg_fits(H, gates):
        NC = gates * H
        for R in REG_ROWS:
            c = clusters["resident"]
            if (rows and R != rows) or c < 1 or 2 * -(-B // R) > c:
                continue
            waves = 1
            cost = reg_step_cost(H, gates, R)
            if best_cost is None or cost < best_cost:
                best = Plan(1, H, NC, -(-NC // COLS) * COLS, R, c, waves, REG_SMEM, 1)
                best_cost = cost
    if best is None:
        raise ValueError(f"no f32 narrow forward plan fits B={B} H={H}")
    return best


def fits(H: int, gates: int = 4) -> bool:
    """Whether the route takes width ``H``: up to ``MAX_H[gates]`` (the
    widths the one-block kernels took), where some split fits a block."""
    return 1 <= H <= MAX_H[gates] and bool(candidates(padded(H), gates))


# ---- the packing -------------------------------------------------------------


def columns(H: int, s: Split) -> torch.Tensor:
    """``(U, NCP)`` int64: the column of ``W_h`` (``gate·H + unit``) that
    block ``b``'s local column ``c`` holds, −1 past the last unit and in the
    padding."""
    cols = wide_layout.columns(H, s)  # (U, NC)
    return torch.cat([cols, cols.new_full((s.U, s.NCP - s.NC), -1)], dim=1)


@functools.lru_cache(maxsize=None)
def _gather_on(H: int, s: Split, device: torch.device):
    """The flat column index :func:`pack_wh` gathers (0 where :func:`columns`
    has none) and the ``(U, 1, NCP)`` mask of those padding columns, or None
    where there are none; made once a split and device: a copy to the card
    from pageable memory would wait for the stream at every launch."""
    cols = columns(H, s)
    pad = cols < 0
    return (cols.clamp(min=0).flatten().to(device),
            pad[:, None, :].to(device) if pad.any() else None)


def pack_wh(wh: torch.Tensor, s: Split) -> torch.Tensor:
    """``(H, gates·H)`` recurrent kernel → ``(U, H, NCP)`` contiguous, block
    ``b``'s columns in :func:`columns` order, zero past the last unit and in
    the padding."""
    H = wh.shape[0]
    if wh.shape[1] != (s.NC // s.Hb) * H or s.U != -(-H // s.Hb):
        raise ValueError(f"{s} is not a split of a {tuple(wh.shape)} recurrent kernel")
    idx, pad = _gather_on(H, s, wh.device)
    packed = wh.index_select(1, idx).view(H, s.U, s.NCP).transpose(0, 1)  # (U, H, NCP)
    return (packed if pad is None else packed.masked_fill(pad, 0)).contiguous()


def unpack_wh(wp: torch.Tensor, s: Split) -> torch.Tensor:
    """Inverse of :func:`pack_wh`."""
    U, H, _ = wp.shape
    cols = columns(H, s)
    wh = wp.new_zeros((H, (s.NC // s.Hb) * H))
    for b in range(U):
        ok = cols[b] >= 0
        wh[:, cols[b][ok]] = wp[b][:, ok]
    return wh


# ---- the sums, replayed ------------------------------------------------------


def _quads(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``a @ b`` over inner index ``n`` as the kernels' four lanes sum it:
    lane ``j`` the indices with ``(n % 16) // 4 == j``, then
    ``(s0 + s1) + (s2 + s3)``."""
    lane = (torch.arange(n) % 16) // 4
    s = [a[:, lane == j] @ b[lane == j] for j in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def replay_recompute(h: torch.Tensor, wp: torch.Tensor, s: Split) -> torch.Tensor:
    """``h (rows, H) · W_h`` → ``(rows, gates·H)`` as the kernels sum it."""
    H = h.shape[1]
    z = h.new_zeros((h.shape[0], (s.NC // s.Hb) * H))
    cols = columns(H, s)
    for b in range(s.U):
        acc = _quads(h, wp[b], H)
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[:, ok]
    return z


def replay_dh(dz: torch.Tensor, wp: torch.Tensor, s: Split) -> list:
    """``dz (rows, gates·H)`` → the ``U`` blocks' ``(rows, H)`` partials of
    ``dz · W_hᵀ`` as the kernels sum them, each over its block's columns
    (the owner of unit ``k`` adds them in block order: :func:`replay_bptt`)."""
    cols = columns(dz.shape[1] // (s.NC // s.Hb), s)
    out = []
    for b in range(s.U):
        dz_b = torch.where(cols[b] >= 0, dz[:, cols[b].clamp(min=0)], 0.0)  # (rows, NCP)
        out.append(_quads(dz_b, wp[b].T, s.NCP))
    return out


def replay_fwd(cell: str, gx_f, gx_b, wh_f, wh_b, *bn, blocks: int = 4):
    """The forward of ``bilstm_fwd_reference(..., with_cells=True)``
    (``cell="lstm"``: → y_f, y_b, c_f, c_b) or ``bigru_fwd_reference``
    (``"gru"``, with ``b_hn`` per direction: → y_f, y_b) in f32, split over at
    most ``blocks`` blocks, its product summed as the ``"narrow_f32"``
    forwards sum it (:func:`replay_recompute`), the gates as they add."""
    gates = 4 if cell == "lstm" else 3
    T, B, G = gx_f.shape
    H = G // gates
    if padded(H) != H:
        raise ValueError(f"replay_fwd runs the kernels' widths, multiples of {K_GRANULE}")
    s = split(H, blocks, gates)
    bns = bn if cell == "gru" else (None, None)
    outs = []
    for gx, wh, b, steps in ((gx_f, wh_f, bns[0], range(T)),
                             (gx_b, wh_b, bns[1], range(T - 1, -1, -1))):
        wp = pack_wh(wh, s)
        h = gx.new_zeros((B, H))
        c = gx.new_zeros((B, H))
        ys, cs = torch.empty_like(gx[..., :H]), torch.empty_like(gx[..., :H])
        for t in steps:
            z = replay_recompute(h, wp, s)
            if cell == "lstm":
                i, f, g, o = (gx[t] + z).split(H, dim=-1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                c = f * c + i * g
                h = o * torch.tanh(c)
            else:
                xr, xz, xn = gx[t].split(H, dim=-1)
                hr, hz, hn = z.split(H, dim=-1)
                rg, zg = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                ng = torch.tanh(xn + rg * (hn + b))
                h = (1.0 - zg) * ng + zg * h
            ys[t], cs[t] = h, c
        outs.append((ys, cs))
    (yf, cf), (yb, cb) = outs
    return (yf, yb, cf, cb) if cell == "lstm" else (yf, yb)


def replay_bptt(cell: str, gx_f, gx_b, wh_f, wh_b, *states, blocks: int = 4):
    """The BPTT of ``bilstm_bwd_reference`` (``cell="lstm"``: states h_prev,
    c_prev, c, dy per direction) or ``bigru_bwd_reference`` (``"gru"``:
    b_hn, h_prev, dy) in f32, split over at most ``blocks`` blocks, its
    products summed as the ``"narrow_f32"`` kernels sum them
    (:func:`replay_recompute`, :func:`replay_dh`, the block partials added in
    block order)."""
    gates = 4 if cell == "lstm" else 3
    T, B, G = gx_f.shape
    H = G // gates
    if padded(H) != H:
        raise ValueError(f"replay_bptt runs the kernels' widths, multiples of {K_GRANULE}")
    s = split(H, blocks, gates)
    if cell == "lstm":
        hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b = states
        dirs = ((gx_f, wh_f, hp_f, cp_f, c_f, dy_f, None, range(T - 1, -1, -1)),
                (gx_b, wh_b, hp_b, cp_b, c_b, dy_b, None, range(T)))
    else:
        bn_f, bn_b, hp_f, hp_b, dy_f, dy_b = states
        dirs = ((gx_f, wh_f, hp_f, None, None, dy_f, bn_f, range(T - 1, -1, -1)),
                (gx_b, wh_b, hp_b, None, None, dy_b, bn_b, range(T)))
    outs = []
    for gx, wh, hp, cp, cs, dy, bn, steps in dirs:
        wp = pack_wh(wh, s)
        partials = [gx.new_zeros((B, H))]  # the carry of the first step
        dc_carry = dhz = gx.new_zeros((B, H))
        dgx = torch.empty_like(gx)
        dnr = torch.empty_like(hp)
        for t in steps:
            z = replay_recompute(hp[t], wp, s)
            carry = dhz.clone()
            for part in partials:
                carry = carry + part
            dh = dy[t] + carry
            if cell == "lstm":
                i, f, g, o = (gx[t] + z).split(H, dim=-1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                tc = torch.tanh(cs[t])
                dc = dc_carry + dh * o * (1.0 - tc * tc)
                dz = torch.cat([dc * g * i * (1.0 - i), dc * cp[t] * f * (1.0 - f),
                                dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
                dgx[t] = dz
                dc_carry = dc * f
                chained = dz
            else:
                xr, xz, xn = gx[t].split(H, dim=-1)
                hr, hz, hn = z.split(H, dim=-1)
                rg, zg = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                ghn = hn + bn
                ng = torch.tanh(xn + rg * ghn)
                dn_pre = dh * (1.0 - zg) * (1.0 - ng * ng)
                dr = dn_pre * ghn * rg * (1.0 - rg)
                dzg = dh * (hp[t] - ng) * zg * (1.0 - zg)
                dgx[t] = torch.cat([dr, dzg, dn_pre], dim=-1)
                dnr[t] = dn_pre * rg
                dhz = dh * zg
                chained = torch.cat([dr, dzg, dnr[t]], dim=-1)
            partials = replay_dh(chained, wp, s)
        outs.append((dgx, dnr))
    (dgx_f, dnr_f), (dgx_b, dnr_b) = outs
    return (dgx_f, dgx_b) if cell == "lstm" else (dgx_f, dgx_b, dnr_f, dnr_b)
