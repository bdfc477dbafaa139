"""The f32 cluster BPTTs (route ``"wide_f32"``): which widths
``csrc/bilstm_bwd_wide_f32.cu`` / ``csrc/bigru_bwd_wide_f32.cu`` take, the
rows a cluster and the storage of ``W_h`` they choose, and the order in which
they sum, replayed in torch.

The split of a direction's units over a cluster, and the per-block packing of
``W_h`` (``(U, H, NC)``, gate-major columns), are the ``"wide"`` route's
(``ops/wide_layout.py::plan`` / ``pack_wh``). A block's f32 slice ``H × NC``
(256 KiB for the LSTM at H = 512, 192 KiB for the GRU) does not fit its
shared memory beside the batch rows, so the kernels cut it into chunks of 64
rows of ``k`` (:func:`chunks`): the last ``nres`` stay resident for the whole
sequence, the first ``nstr`` are streamed every step through a ring of
three slots (``RING``), and each chunk feeds both products of a step: the
recompute's ``h_prev · W_h`` over the chunk's ``k`` and ``dz · W_hᵀ`` for the
chunk's ``k``. The rows a cluster (R = 8, 16 or 24: row tiles of 8) trade
against the resident chunks (:func:`rows`, :func:`smem_bytes`).

Both products run on CUDA cores in f32 (``wide_f32_common.cuh``), summed as
:func:`replay_recompute` and :func:`replay_dh` replay: block ``b``'s
recompute of column ``c`` in four lanes, lane ``j`` taking the ``k`` with
``(k % 16) // 4 == j``, added ``(s0 + s1) + (s2 + s3)``; its ``dh`` partial
for ``k`` in four lanes, lane ``i`` taking the columns with
``(c % 16) // 4 == i``, met in a reduce-scatter that leaves row ``k`` with
lane ``k % 4`` as ``(a_i + a_i^2) + (a_i^1 + a_i^3)``; the owner of unit
``k`` adds the ``U`` block partials in block order (the GRU after its own
``dh·z``) (:func:`replay_bptt`).

The route's forwards (``csrc/{bilstm,bigru}_fwd_wide_f32.cu``,
``wide_f32_fwd.cuh``) take the same split, packing and chunks: R = 8 or 4
rows a cluster (``FWD_ROWS``, by a step estimate), the last ``nres`` chunks
resident in shared memory
beside two buffers of the rows of ``h`` and the partials of the product, the
first ``nreg`` (at most ``FWD_MAX_REG``) in registers, none streamed
(:func:`fwd_rows`, :func:`fwd_smem_bytes`). Their one product runs on
:func:`fwd_threads` threads: lane ``(kw, j)`` of a column group takes, in
every chunk, the k-quad ``4·kw + j``; the four ``j`` lanes' reduce-scatter
adds ``(s0 + s2) + (s1 + s3)`` and the gate phase the four groups ``kw``,
``((p0 + p1) + p2) + p3`` (:func:`replay_fwd_product`, :func:`replay_fwd`).

For at most ``FEW_MAX_B`` batch rows the BPTTs take a plan of their own
(``csrc/wide_f32_few.cuh``): R = 4, 2 or 1 rows a cluster (``FEW_ROWS``, by
a step estimate, :func:`bwd_plan`), the whole slice resident in shared
memory beside them, unpadded (the 16-word halves of a row swapped on every
other k-quad), no chunk barrier and no cluster barrier in the loop: the dh
partials go to their owners by ``st.async``, counted by the owner's
mbarrier (:func:`few_fits`, :func:`few_smem_bytes`). Its recompute sums as
the forwards' product (:func:`replay_fwd_product`), its dh partials as the
chunked kernels' (:func:`replay_dh`): ``replay_bptt(..., few=True)``.

The kernels take ``H`` a multiple of 32 (``K_GRANULE``) and at least three
chunks (H > 128: a chunk's ``h_prev`` rows load two chunks ahead of their
use); the wrappers zero-pad other widths (``ops/lstm_cuda.py::at_width``, exact). A
block's ``NC`` gate columns are at most 128 (an m16 tile a warp of the
recompute): H up to 512 for both cells (:func:`fits`, :func:`max_h`). Wider f32
layers stay on ``"wide"``; ``ops/mma_layout.py::fwd_route`` and
``bwd_route`` hold the rule.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from percivaltts_tpu_torch.ops import wide_layout

CHUNK = 64  # rows of k a chunk of a block's W_h slice
RING = 3  # ring slots of the streamed chunks (each issued two chunks ahead)
K_GRANULE = 32  # H is a whole number of these
MAX_NC = 128  # gate columns a block: 32 a recompute warp, 4 warps a half of the rows
ROW_TILES = (1, 2, 3)  # R = 8·NT rows a cluster
THREADS = 384  # 12 warps: 8 for the recompute, 4 for the dh product
SMEM_OPTIN = 232_448  # dynamic shared memory a block may opt into on the H100 (227 KB)
FWD_ROWS = (8, 4)  # the forwards' batch rows a cluster, as their plan weighs them
FWD_GROUPS = 4  # the forwards' k-quad groups: warps a column group
FWD_MAX_REG = 3  # chunks the forwards hold in registers (16 words a chunk a column quad)
FWD_STATIC_SMEM = 16  # the forwards' two mbarriers, beside their dynamic shared memory
# the forwards' step estimate, ns (wide_f32_fwd.cuh: kWffStepNs, kWffFmaPerNs):
# a fixed part and the product's R·NC·H FMAs a block at a rate
FWD_STEP_NS = 1500
FWD_FMA_PER_NS = 165
FEW_ROWS = (4, 2, 1)  # the few-row BPTT plan's rows a cluster, as it weighs them
FEW_MAX_B = 8  # the batch rows up to which the BPTT plan takes them
FEW_NC = (96, 128)  # a block's gate columns its kernels are built for
FEW_GROUPS = 4  # its recompute's k-quad groups
FEW_STATIC_SMEM = 16  # its two mbarriers, beside its dynamic shared memory
# its step estimate (wide_f32_few.cuh: kWfrStepNs, kWfrWordPs, kWfrRowWordPs):
# a fixed part in ns, ps a word of the block's W_h slice and a word and row
FEW_STEP_NS = 1450
FEW_WORD_PS = 21
FEW_ROW_WORD_PS = 17


class Rows(NamedTuple):
    R: int  # batch rows a cluster
    nres: int  # chunks resident in shared memory
    nstr: int  # chunks streamed every step
    waves: int  # ceil(2·ceil(B / R) / clusters)
    smem: int  # dynamic shared memory a block, bytes


def padded(H: int) -> int:
    """The width the kernels run ``H`` at: the next multiple of 32."""
    return -(-H // K_GRANULE) * K_GRANULE


def chunks(H: int) -> list:
    """``[(k0, rows)]``: the 64-row chunks of a slice of width ``H`` (the last
    one shorter when ``H % 64``)."""
    return [(k0, min(CHUNK, H - k0)) for k0 in range(0, H, CHUNK)]


def slot_bytes(NC: int) -> int:
    """A chunk's bytes in shared memory: 64 rows of ``NC + 4`` f32 (rows 4
    apart lie 16 banks apart)."""
    return 4 * CHUNK * (NC + 4)


def smem_bytes(H: int, gates: int, R: int, nres: int) -> int:
    """A block's dynamic shared memory at width ``H`` (a multiple of 32), ``R``
    rows a cluster and ``nres`` resident chunks (``wide_f32_common.cuh::
    wf_smem``): the ring's three slots (none when every chunk is resident) and
    the resident chunks, ``64 × (NC + 4)`` f32 each; the ``h_prev`` rows
    (``R × H``), the ``dz`` and ``z`` rows (``R × (NC + 8)`` each) and the
    partial slots (``U × Hb × R``), all f32."""
    p = wide_layout.plan(H, gates)
    nch = len(chunks(H))
    slots = nres + (RING if nres < nch else 0)
    return slots * slot_bytes(p.NC) + 4 * (R * H + 2 * R * (p.NC + 8) + p.U * p.Hb * R)


def resident(H: int, gates: int, R: int) -> int:
    """The most chunks that stay resident beside ``R`` rows within
    ``SMEM_OPTIN``, or −1 when not even a fully streamed block fits."""
    nch = len(chunks(H))
    for n in range(nch, -1, -1):
        if smem_bytes(H, gates, R, n) <= SMEM_OPTIN:
            return n
    return -1


def fits(H: int, gates: int = 4) -> bool:
    """Whether the kernels take width ``H`` (padded to a multiple of 32): at
    least three chunks, at most 128 gate columns a block (whole units of 8 a
    gate-phase tile), and 8 rows a cluster with every chunk streamed within
    ``SMEM_OPTIN``."""
    Hp = padded(H)
    if len(chunks(Hp)) < 3 or Hp > wide_layout.max_h(gates):
        return False
    p = wide_layout.plan(Hp, gates)
    return p.NC <= MAX_NC and p.Hb % 8 == 0 and resident(Hp, gates, 8) >= 0


@functools.cache
def max_h(gates: int = 4) -> int:
    """The widest H the kernels take (512 for both cells)."""
    return max(H for H in range(K_GRANULE, wide_layout.max_h(gates) + 1, K_GRANULE)
               if fits(H, gates))


def _clusters_at(clusters):
    return (lambda R: clusters[R]) if isinstance(clusters, dict) else (lambda R: clusters)


def rows(B: int, H: int, gates: int, clusters, only: int = 0) -> Rows:
    """The chunked kernels' choice for ``B`` rows at width ``H`` (a multiple
    of 32) when the card holds ``clusters`` clusters of them at once (one
    number, or a dict by R; ``percival_*_bwd_wide_f32_plan`` reports both):
    among R = 8, 16, 24 (``only``: that R alone) whose block fits, each with
    the most resident chunks beside it, the fewest waves, then the smallest
    R."""
    at = _clusters_at(clusters)
    best = None
    for nt in ROW_TILES:
        R = 8 * nt
        if only and R != only:
            continue
        nres = resident(H, gates, R)
        if nres < 0:
            continue
        waves = -(-2 * -(-B // R) // at(R))
        r = Rows(R, nres, len(chunks(H)) - nres, waves, smem_bytes(H, gates, R, nres))
        if best is None or r.waves < best.waves:
            best = r
    if best is None:
        raise ValueError(f"no f32 cluster BPTT plan fits H={H}")
    return best


class BwdPlan(NamedTuple):
    """A BPTT launch plan as ``percival_*_bwd_wide_f32_plan`` returns it."""
    U: int  # blocks a cluster
    Hb: int  # units a block
    NC: int  # gate columns a block
    R: int  # batch rows a cluster: 1, 2, 4 the few-row kernels, 8, 16, 24 the chunked ones
    nres: int  # chunks resident in shared memory (all of them at R <= 4)
    nstr: int  # chunks streamed every step
    clusters: int  # clusters the card holds at once
    waves: int  # ceil(2·ceil(B / R) / clusters)
    smem: int  # dynamic shared memory a block, bytes


def few_threads(H: int, gates: int) -> int:
    """The few-row kernels' threads a block: 4·NC (384 at NC = 96, 512 at
    128), a lane of both products each."""
    return 4 * wide_layout.plan(H, gates).NC


def few_smem_bytes(H: int, gates: int, R: int) -> int:
    """A few-row block's dynamic shared memory at width ``H`` (a multiple of
    32) and ``R`` rows (``wide_f32_few.cuh::wfr_smem``): the whole slice
    ``H × NC``, the ``h_prev`` rows ``R × H``, the recompute's partials
    ``4 × R × NC``, the ``dz`` rows ``R × NC`` and two buffers of receiving
    slots ``U × R × Hb``, all f32."""
    p = wide_layout.plan(H, gates)
    return 4 * (H * p.NC + R * H + FEW_GROUPS * R * p.NC + R * p.NC + 2 * p.U * R * p.Hb)


def few_fits(H: int, gates: int, R: int) -> bool:
    """Whether the few-row kernels take ``R`` rows at width ``H`` (a multiple
    of 32): the route's width, a block's NC one they are built for, and the
    block within ``SMEM_OPTIN`` beside the mbarriers."""
    return (R in FEW_ROWS and fits(H, gates) and wide_layout.plan(H, gates).NC in FEW_NC
            and few_smem_bytes(H, gates, R) + FEW_STATIC_SMEM <= SMEM_OPTIN)


def few_step_ns(H: int, gates: int, R: int) -> int:
    """The few-row kernels' step estimate at ``R`` rows a cluster, ns."""
    words = H * wide_layout.plan(H, gates).NC
    return FEW_STEP_NS + words * (FEW_WORD_PS + FEW_ROW_WORD_PS * R) // 1000


def bwd_plan(B: int, H: int, gates: int, clusters, only: int = 0) -> Rows:
    """The BPTT launcher's plan for ``B`` rows at width ``H`` (a multiple of
    32), ``clusters`` the clusters the card holds at once (a dict by R, or
    one number for all): at ``B <= FEW_MAX_B`` the few-row plan where one of
    ``FEW_ROWS`` fits, the R of least waves × :func:`few_step_ns` (the larger
    R on a tie), else the chunked plan (:func:`rows`). ``only`` forces R
    (1, 2, 4: few-row; 8, 16, 24: chunked); ``ValueError`` when it does not
    fit."""
    at = _clusters_at(clusters)
    if (only <= 4) if only else B <= FEW_MAX_B:
        best, best_cost = None, None
        for R in FEW_ROWS:
            if (only and R != only) or not few_fits(H, gates, R) or at(R) < 1:
                continue
            waves = -(-2 * -(-B // R) // at(R))
            cost = waves * few_step_ns(H, gates, R)
            if best is None or cost < best_cost:
                best = Rows(R, len(chunks(H)), 0, waves, few_smem_bytes(H, gates, R))
                best_cost = cost
        if best is not None:
            return best
        if only:
            raise ValueError(f"no few-row f32 BPTT plan of R={only} fits H={H}")
    return rows(B, H, gates, clusters, only=only)


# the forwards' narrowest H a cell: past the one-block widths, where a
# block's NC is 96 or 128 and its slice 5–8 chunks (the instantiated kernels)
FWD_MIN_H = {4: 257, 3: 321}


def fwd_fits(H: int, gates: int = 4) -> bool:
    """Whether the forwards take width ``H`` (padded to a multiple of 32):
    ``FWD_MIN_H`` up to 512."""
    return FWD_MIN_H[gates] <= H and fits(H, gates)


class FwdRows(NamedTuple):
    R: int  # batch rows a cluster
    nres: int  # chunks resident in shared memory (the last ones)
    nreg: int  # chunks held in registers (the first ones)
    waves: int  # ceil(2·ceil(B / R) / clusters)
    smem: int  # dynamic shared memory a block, bytes


def fwd_quads(NC: int) -> int:
    """The column quads a lane of the forwards' product holds: 2 (8
    columns) at NC = 128, 1 at NC = 96."""
    return 2 if NC == 128 else 1


def fwd_threads(H: int, gates: int) -> int:
    """The forwards' threads a block: four k-quad groups of
    ``NC / (32·fwd_quads)`` warps (256 at NC = 128, 384 at 96)."""
    NC = wide_layout.plan(H, gates).NC
    return FWD_GROUPS * NC // fwd_quads(NC)


def fwd_smem_bytes(H: int, gates: int, nres: int, R: int = 8) -> int:
    """A forward block's dynamic shared memory at width ``H`` (a multiple of
    32), ``R`` rows a cluster and ``nres`` resident chunks
    (``wide_f32_fwd.cuh::wff_smem``): the chunks, ``64 × (NC + 4)`` f32
    each; two buffers of the ``h`` rows, k-quad major with the R rows' quads
    padded to R + 1 (``2 × H/4 × (R + 1) × 4``), and the product's partials
    (``4 × R × NC``), all f32."""
    p = wide_layout.plan(H, gates)
    h_rows = 2 * (H // 4) * 4 * (R + 1)
    return nres * slot_bytes(p.NC) + 4 * (h_rows + FWD_GROUPS * R * p.NC)


def fwd_step_ns(H: int, gates: int, R: int) -> int:
    """The forwards' step estimate at ``R`` rows a cluster, ns."""
    return FWD_STEP_NS + R * wide_layout.plan(H, gates).NC * H // FWD_FMA_PER_NS


def fwd_rows(B: int, H: int, gates: int, clusters: int) -> FwdRows:
    """The forwards' plan for ``B`` rows at width ``H`` (a multiple of 32)
    when the card holds ``clusters`` clusters of the kernel at once
    (``percival_*_fwd_wide_f32_plan`` reports them): for R = 8 and 4, the
    most chunks that fit ``SMEM_OPTIN`` beside the mbarriers resident, the first others in
    registers (at most ``FWD_MAX_REG``); the R of least waves ×
    :func:`fwd_step_ns`, 8 on a tie (``ValueError`` when none fits)."""
    nch = len(chunks(H))
    best, best_cost = None, None
    for R in FWD_ROWS:
        room = SMEM_OPTIN - FWD_STATIC_SMEM
        nres = next(n for n in range(nch, -1, -1)
                    if n == 0 or fwd_smem_bytes(H, gates, n, R) <= room)
        nreg = nch - nres
        if nreg > FWD_MAX_REG or fwd_smem_bytes(H, gates, nres, R) > room:
            continue
        waves = -(-2 * -(-B // R) // clusters)
        cost = waves * fwd_step_ns(H, gates, R)
        if best is None or cost < best_cost:
            best = FwdRows(R, nres, nreg, waves, fwd_smem_bytes(H, gates, nres, R))
            best_cost = cost
    if best is None:
        raise ValueError(f"no f32 cluster forward plan fits H={H}")
    return best


# ---- the sums, replayed ------------------------------------------------------


def _lane_sums(a: torch.Tensor, b: torch.Tensor, lane: torch.Tensor) -> list:
    """``a @ b`` in four partial products, lane ``j`` taking the inner
    indices ``n`` with ``lane[n] == j``."""
    return [a[:, lane == j] @ b[lane == j] for j in range(4)]


def replay_recompute(h: torch.Tensor, wp: torch.Tensor, p: wide_layout.Plan) -> torch.Tensor:
    """``h (rows, H) · W_h`` → ``(rows, gates·H)`` as the kernels sum it: each
    block's column over four k-quad lanes (``(k % 16) // 4``), added
    ``(s0 + s1) + (s2 + s3)``."""
    H = h.shape[1]
    z = h.new_zeros((h.shape[0], wide_layout.gates_of(p) * H))
    cols = wide_layout.columns(H, p)
    lane = (torch.arange(H) % 16) // 4
    for b in range(p.U):
        s = _lane_sums(h, wp[b], lane)
        acc = (s[0] + s[1]) + (s[2] + s[3])
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[:, ok]
    return z


def replay_dh(dz: torch.Tensor, wp: torch.Tensor, p: wide_layout.Plan) -> list:
    """``dz (rows, gates·H)`` → the ``U`` blocks' ``(rows, H)`` partials of
    ``dz · W_hᵀ`` as the kernels sum them: each over four column lanes
    (``(c % 16) // 4``), met in the reduce-scatter's order, row ``k`` with
    lane ``i = k % 4`` as ``(a_i + a_i^2) + (a_i^1 + a_i^3)``. The owner of
    unit ``k`` adds them in block order (:func:`replay_bptt`)."""
    H = dz.shape[1] // wide_layout.gates_of(p)
    cols = wide_layout.columns(H, p)
    lane = (torch.arange(p.NC) % 16) // 4
    i = torch.arange(H) % 4
    out = []
    for b in range(p.U):
        dz_b = torch.where(cols[b] >= 0, dz[:, cols[b].clamp(min=0)], 0.0)  # (rows, NC)
        a = _lane_sums(dz_b, wp[b].T, lane)  # (rows, H) each
        tree = [(a[j] + a[j ^ 2]) + (a[j ^ 1] + a[j ^ 3]) for j in range(4)]
        out.append(torch.stack(tree)[i, :, torch.arange(H)].T)
    return out


def replay_bptt(cell: str, gx_f, gx_b, wh_f, wh_b, *states, few: bool = False):
    """The BPTT of ``bilstm_bwd_reference`` (``cell="lstm"``: states h_prev,
    c_prev, c, dy per direction) or ``bigru_bwd_reference`` (``"gru"``:
    b_hn, h_prev, dy) in f32, its products summed as the chunked
    ``"wide_f32"`` kernels sum them (:func:`replay_recompute`,
    :func:`replay_dh`, the block partials added in block order), or with
    ``few`` as the few-row kernels do (the recompute as
    :func:`replay_fwd_product`)."""
    recompute = replay_fwd_product if few else replay_recompute
    gates = 4 if cell == "lstm" else 3
    T, B, G = gx_f.shape
    H = G // gates
    if padded(H) != H:
        raise ValueError(f"replay_bptt runs the kernels' widths, multiples of {K_GRANULE}")
    p = wide_layout.plan(H, gates)
    outs = []
    if cell == "lstm":
        hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b = states
        dirs = ((gx_f, wh_f, hp_f, cp_f, c_f, dy_f, None, range(T - 1, -1, -1)),
                (gx_b, wh_b, hp_b, cp_b, c_b, dy_b, None, range(T)))
    else:
        bn_f, bn_b, hp_f, hp_b, dy_f, dy_b = states
        dirs = ((gx_f, wh_f, hp_f, None, None, dy_f, bn_f, range(T - 1, -1, -1)),
                (gx_b, wh_b, hp_b, None, None, dy_b, bn_b, range(T)))
    for gx, wh, hp, cp, cs, dy, bn, steps in dirs:
        wp = wide_layout.pack_wh(wh, p)
        partials = [gx.new_zeros((B, H))]  # the carry of the first step
        dc_carry = dhz = gx.new_zeros((B, H))
        dgx = torch.empty_like(gx)
        dnr = torch.empty_like(hp)
        for t in steps:
            z = recompute(hp[t], wp, p)
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
            partials = replay_dh(chained, wp, p)
        outs.append((dgx, dnr))
    (dgx_f, dnr_f), (dgx_b, dnr_b) = outs
    return (dgx_f, dgx_b) if cell == "lstm" else (dgx_f, dgx_b, dnr_f, dnr_b)


def replay_fwd_product(h: torch.Tensor, wp: torch.Tensor, p: wide_layout.Plan) -> torch.Tensor:
    """``h (rows, H) · W_h`` → ``(rows, gates·H)`` as the forwards sum it: in
    block ``b``, the lane of k-quad group ``kw`` and k lane ``j`` takes the
    ``k`` whose quad within its chunk is ``4·kw + j`` (``(k % 64) // 4``); the
    ``j`` lanes' reduce-scatter adds ``(s0 + s2) + (s1 + s3)``, then the
    groups ``((p0 + p1) + p2) + p3``."""
    H = h.shape[1]
    z = h.new_zeros((h.shape[0], wide_layout.gates_of(p) * H))
    cols = wide_layout.columns(H, p)
    quad = (torch.arange(H) % CHUNK) // 4
    for b in range(p.U):
        parts = []
        for kw in range(FWD_GROUPS):
            s = _lane_sums(h, wp[b], torch.where(quad // 4 == kw, quad % 4, -1))
            parts.append((s[0] + s[2]) + (s[1] + s[3]))
        acc = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        ok = cols[b] >= 0
        z[:, cols[b][ok]] = acc[:, ok]
    return z


def replay_fwd(cell: str, gx_f, gx_b, wh_f, wh_b, bn_f=None, bn_b=None, with_cells: bool = False):
    """The forward of ``bilstm_fwd_reference`` (``cell="lstm"``; ``(y_f,
    y_b)``, and ``(c_f, c_b)`` beside them when ``with_cells``) or
    ``bigru_fwd_reference`` (``"gru"``, with ``bn_f`` / ``bn_b``) in f32,
    its product summed as the ``"wide_f32"`` forwards sum it
    (:func:`replay_fwd_product`)."""
    gates = 4 if cell == "lstm" else 3
    T, B, G = gx_f.shape
    H = G // gates
    if padded(H) != H:
        raise ValueError(f"replay_fwd runs the kernels' widths, multiples of {K_GRANULE}")
    p = wide_layout.plan(H, gates)
    outs = []
    for gx, wh, bn, steps in ((gx_f, wh_f, bn_f, range(T)), (gx_b, wh_b, bn_b, range(T - 1, -1, -1))):
        wp = wide_layout.pack_wh(wh, p)
        h = gx.new_zeros((B, H))
        c = torch.zeros_like(h)
        y, cs = gx.new_empty((T, B, H)), gx.new_empty((T, B, H))
        for t in steps:
            z = replay_fwd_product(h, wp, p)
            if cell == "lstm":
                i, f, g, o = (gx[t] + z).split(H, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                xr, xz, xn = gx[t].split(H, dim=-1)
                hr, hz, hn = z.split(H, dim=-1)
                rg, zg = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                ng = torch.tanh(xn + rg * (hn + bn))
                h = (1.0 - zg) * ng + zg * h
            y[t], cs[t] = h, c
        outs.append((y, cs))
    (yf, cf), (yb, cb) = outs
    if cell == "lstm" and with_cells:
        return yf, yb, cf, cb
    return yf, yb
