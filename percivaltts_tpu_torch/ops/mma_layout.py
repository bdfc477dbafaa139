"""The tensor-core route of the recurrent kernels: which calls take it, and
the row order of ``W_hᵀ`` that the forwards' warps hold in registers.

``csrc/bilstm_fwd_mma.cu`` and ``csrc/bigru_fwd_mma.cu`` compute each step's
recurrent product transposed, ``zᵀ (G × 8) = W_hᵀ (G × H) · hᵀ (H × 8)``, with
``mma.sync`` m16n8k16 tiles: 16 gate rows by the block's 8 batch rows. The
m16n8 accumulator gives lane ``l`` of a warp rows ``l // 4`` and
``l // 4 + 8`` of a tile, for batch rows ``2·(l % 4)`` and ``2·(l % 4) + 1``.
The wrapper packs ``W_hᵀ`` with its gate rows permuted (:func:`pack_wh`) so
that those two rows, over a warp's tiles, are every gate of the same unit:

- LSTM (``G = 4H``, ``H / 8`` warps): warp ``w`` owns units ``8w … 8w+7``;
  its tile 0 is ``i | f`` and tile 1 ``g | o`` of those units, so lane ``l``
  holds i, f, g, o of unit ``8w + l // 4``;
- GRU (``G = 3H``, ``H / 16`` warps): warp ``w`` owns units
  ``16w … 16w+15``; tile 0 is ``r | z`` of units ``16w … 16w+7``, tile 1
  ``r | z`` of ``16w+8 … 16w+15``, tile 2 ``n`` of the first eight | ``n``
  of the second eight, so lane ``l`` holds r, z, n of units
  ``16w + l // 4`` and ``16w + 8 + l // 4``.

The route covers bf16 with ``H`` a multiple of 16 (the MMA depth) up to 128
(the register budget of a thread); other calls take the one-block CUDA-core
kernels up to ``LSTM_SIMT_MAX_H`` / ``GRU_SIMT_MAX_H``, and past it the
cluster kernels: on the tensor cores in bf16 where a block's share of
``W_hᵀ`` fits its shared memory (``ops/wide_mma_layout.py``), else on CUDA
cores (``ops/wide_layout.py``) but in bf16 up to H = 1536 / 1792, where both
passes stream the slice from L2 into the tensor-core kernels
(``"wide_mma_stream"``), and past it up to 4096 the BPTT, on the streamed
kernels' deep layout (the forward there stays on CUDA cores until its own
redesign); f32 there takes its own cluster
kernels up to H = 512 (``ops/wide_f32_layout.py``), and at the one-block
widths both f32 passes take cluster kernels too, which hold W_h on chip for
all of a cluster's rows (``ops/narrow_f32_layout.py``).

The tensor-core BPTT kernels (``csrc/bilstm_bwd_mma.cu``,
``csrc/bigru_bwd_mma.cu``, :func:`bwd_route`) give every warp 16 units, for
both cells: ``H / 16`` warps. Their recompute reads the same packed
``W_hᵀ`` (an LSTM warp takes the forward's rows of two 8-unit groups, so
lane ``l`` holds i, f, g, o of units ``16w + l // 4`` and ``16w + 8 + l // 4``).
Their chained product ``dhᵀ (H × 8) = W_h (H × G) · dzᵀ (G × 8)`` reads
``W_h`` itself, unpacked: warp ``w`` takes the m16 tile of its own 16 units,
whose accumulator lands on lane ``l`` as those same two units.
"""

from __future__ import annotations

import functools

import torch

from percivaltts_tpu_torch.ops import narrow_f32_layout, wide_f32_layout, wide_mma_layout

MMA_K = 16  # depth of one m16n8k16 product: H is a whole number of them
# W_h in registers at H=128, 32-bit registers a thread: forward 64 (LSTM) / 96
# (GRU), BPTT 128 / 96
MMA_MAX_H = 128
GATES = {"lstm": 4, "gru": 3}


def mma_width_ok(H: int) -> bool:
    return H % MMA_K == 0 and 0 < H <= MMA_MAX_H


# the widest H the LSTM's one-block CUDA-core kernels run (one thread per
# gate column, 4H <= 1024); in bf16 the cluster kernels measured faster from
# H = 129 on (chip_smoke.py phase 13a at (512, 32, 256); PERF.md, PR 14)
LSTM_SIMT_MAX_H = {torch.float32: 256, torch.bfloat16: MMA_MAX_H}
# the GRU's: its one-block BPTT takes H up to 320 (whole warps of its 3H
# threads); in bf16 the cluster kernels measured faster from H = 129 on
# (chip_smoke.py phase 14a at (512, 32, 256); PERF.md, its kernel table)
GRU_SIMT_MAX_H = {torch.float32: 320, torch.bfloat16: MMA_MAX_H}
SIMT_MAX_H = {"lstm": LSTM_SIMT_MAX_H, "gru": GRU_SIMT_MAX_H}
# where the f32 forward keeps the CUDA-core cluster kernel ("wide") over
# "wide_f32": (H, B) pairs, "wide" wherever H <= h and B <= b for one of
# them. The card measured the CUDA-core cluster
# forward faster than "wide_f32" only at the GRU's H = 336 with B <= 3 (the
# old kernel runs 336 as it is, one row a cluster with W_h in shared
# memory; "wide_f32" pads it to 352 and runs 4 rows: 1.05–1.10x at
# B = 1–3, and "wide_f32" 1.03–1.11x at B = 4–6, in turns), and "wide_f32"
# faster at the other points it timed (H = 264–512, B = 1–160; python3
# chip_smoke.py --f32-times, PERF.md)
F32_WIDE_FWD = {"lstm": (), "gru": ((336, 3),)}
# where the bf16 BPTT keeps the CUDA-core cluster kernel ("wide") over the
# streamed tensor-core one ("wide_mma_stream"), as F32_WIDE_FWD. The card
# measured "wide" faster only at the LSTM's H = 609–640 with B <= 3, where
# its block holds the whole W_h slice in shared memory and runs the few
# rows there (at H = 640: 1.004–1.04x; at 624, which the streamed kernel pads
# to 640, 1.11–1.12x, in turns), and the streamed kernel faster at the other
# points it timed (1.20x at H = 640, B = 4; 2.3–31.7x at H = 640–1792,
# B = 1–160; python3 chip_smoke.py --bf16-wide-times, PERF.md)
BF16_WIDE_BWD = {"lstm": ((640, 3),), "gru": ()}
# where the bf16 forward keeps the CUDA-core cluster kernel ("wide") over the
# streamed tensor-core one ("wide_mma_stream"), as BF16_WIDE_BWD. The card
# measured "wide" faster only at the LSTM's H = 640 with B <= 6, where its
# block holds the whole W_h slice (1.13–1.32x in turns), and the streamed
# forward faster at the other 84 points it timed (1.11–7.38x at H =
# 640–1792, B = 1–8, 32, 160; the LSTM at H = 640, B = 7: 1.67x, at
# H = 768, B <= 8: 1.27–1.66x; python3 chip_smoke.py --bf16-wide-times,
# PERF.md)
BF16_WIDE_FWD = {"lstm": ((640, 6),), "gru": ()}


def fwd_route(dtype: torch.dtype, H: int, cell: str = "lstm", B: int | None = None) -> str:
    """The forward kernel a CUDA call launches, chosen before the launch
    from its dtype, width and cell: ``"mma"`` (tensor cores) for bf16 with H
    a multiple of 16 up to 128; past
    ``LSTM_SIMT_MAX_H`` (256 in f32, 128 in bf16) / ``GRU_SIMT_MAX_H`` (320
    in f32, 128 in bf16) a cluster of blocks a direction: ``"wide_mma"``
    (``csrc/bilstm_fwd_wide_mma.cu`` / ``csrc/bigru_fwd_wide_mma.cu``,
    tensor cores) for bf16 wherever a block's ``W_hᵀ`` slice and tiles fit
    its shared memory (``wide_mma_layout.fits``: H up to 608 for the LSTM,
    672 for the GRU); past it ``"wide_mma_stream"``
    (``csrc/{bilstm,bigru}_fwd_wide_mma_stream.cu``, tensor cores, the
    slice streamed from L2 in chunks) up to ``wide_mma_layout.stream_fwd_max_h``
    (1536 / 1792: where the BPTT's 64-k layout fits) unless ``BF16_WIDE_FWD``
    keeps ``"wide"`` for so few rows ``B``; ``"wide_f32"``
    (``csrc/{bilstm,bigru}_fwd_wide_f32.cu``, a block's f32 ``W_h`` slice
    held on chip, in shared memory and registers) for f32 wherever
    ``wide_f32_layout.fits`` (H up to 512) and ``F32_WIDE_FWD`` does not
    keep ``"wide"`` for so few rows ``B`` (without ``B``, a large batch's
    route); else ``"wide"`` (``csrc/bilstm_fwd_wide.cu`` /
    ``csrc/bigru_fwd_wide.cu``, CUDA cores: f32 past 512, bf16 past the
    streamed forward's widths, ``wide_mma_layout.stream_fwd_max_h``: the
    BPTT's route goes further, :func:`bwd_route`); up to the one-block widths f32 takes
    ``"narrow_f32"`` (``csrc/{bilstm,bigru}_fwd_narrow_f32.cu``, a cluster
    a direction holding W_h on chip, ``narrow_f32_layout.fits``; the card
    measured it faster than ``"simt"`` at every width and batch it timed:
    H = 64–256 / 320, B = 1–160, ``python3 chip_smoke.py --f32-times``,
    PERF.md); everything else ``"simt"`` (``csrc/bilstm_fwd.cu`` /
    ``csrc/bigru_fwd.cu``, one block a direction, one thread per gate
    column)."""
    if cell not in GATES:
        raise ValueError(f"cell must be one of {tuple(GATES)}, got {cell!r}")
    if dtype == torch.bfloat16 and mma_width_ok(H):
        return "mma"
    limits = SIMT_MAX_H[cell]
    if H <= limits.get(dtype, limits[torch.float32]):
        if dtype == torch.float32 and narrow_f32_layout.fits(H, GATES[cell]):
            return "narrow_f32"
        return "simt"
    if dtype == torch.bfloat16 and wide_mma_layout.fits(H, GATES[cell]):
        return "wide_mma"
    if dtype == torch.bfloat16 and wide_mma_layout.stream_fits(H, GATES[cell]):
        return "wide" if _kept(BF16_WIDE_FWD[cell], H, B) else "wide_mma_stream"
    if dtype == torch.float32 and wide_f32_layout.fits(H, GATES[cell]):
        return "wide" if _kept(F32_WIDE_FWD[cell], H, B) else "wide_f32"
    return "wide"


def _kept(table: tuple, H: int, B: int | None) -> bool:
    """Whether a measured ``(h, b)`` table keeps ``"wide"`` at width ``H``
    for ``B`` rows (``H <= h`` and ``B <= b`` for one of its rows; without
    ``B``, a large batch: never)."""
    return B is not None and any(H <= h and B <= b for h, b in table)


def bwd_route(dtype: torch.dtype, H: int, cell: str = "lstm", B: int | None = None) -> str:
    """The BPTT kernel a CUDA call launches: :func:`fwd_route`'s route for
    a large batch (``"mma"``, ``"wide_mma"``, ``"wide_mma_stream"``,
    ``"wide_f32"``, ``"narrow_f32"``, ``"wide"`` or ``"simt"``, the same
    kernels' BPTTs: ``csrc/{bilstm,bigru}_bwd{,_mma,_wide_mma,
    _wide_mma_stream,_wide_f32,_narrow_f32,_wide}.cu``), but ``"wide"``
    where ``BF16_WIDE_BWD`` keeps it for so few rows ``B`` (the card
    measured the CUDA-core BPTT faster there), and ``"wide_mma_stream"``
    for bf16 past the forward's streamed widths up to
    ``wide_mma_layout.stream_bwd_max_h`` (4096: the streamed BPTT's deep
    layout, where the forward stays on ``"wide"``; the two passes part there
    until the forward's redesign). In f32 the
    ``"narrow_f32"`` BPTT was measured faster than ``"simt"`` at every width
    and batch timed (H = 64–256 / 320, B = 1–160, ``python3 chip_smoke.py
    --f32-times``, PERF.md); the ``"wide_f32"`` launcher takes its few-row
    kernels at B <= 8 (``csrc/wide_f32_few.cuh``), measured faster than
    ``"wide"`` at every width and B <= 8 timed (PERF.md)."""
    route = fwd_route(dtype, H, cell)
    if route == "wide_mma_stream" and _kept(BF16_WIDE_BWD[cell], H, B):
        return "wide"
    if (route == "wide" and dtype == torch.bfloat16
            and wide_mma_layout.stream_bwd_fits(H, GATES[cell])):
        return "wide_mma_stream"
    return route


def _check(kind: str, H: int) -> None:
    if kind not in GATES:
        raise ValueError(f"kind must be one of {tuple(GATES)}, got {kind!r}")
    if not mma_width_ok(H):
        raise ValueError(
            f"the tensor-core route takes H a multiple of {MMA_K} up to {MMA_MAX_H}, got H={H}"
        )


def gate_rows(kind: str, H: int) -> torch.Tensor:
    """``(G,)`` int64: packed row ``p`` of ``W_hᵀ`` holds column
    ``gate_rows(kind, H)[p]`` (``gate·H + unit``) of ``W_h``."""
    _check(kind, H)
    p = torch.arange(GATES[kind] * H)
    half, r = (p // 8) % 2, p % 8  # tile rows 0–7 | 8–15
    if kind == "lstm":  # 32 rows a warp: tiles i|f, g|o of units 8w…8w+7
        w, tile = p // 32, (p // 16) % 2
        return (2 * tile + half) * H + 8 * w + r
    w, tile = p // 48, (p // 16) % 3  # 48 rows a warp: r|z, r|z, n|n of units 16w…16w+15
    gate = torch.where(tile < 2, half, 2)
    unit = 16 * w + torch.where(tile < 2, 8 * tile, 8 * half) + r
    return gate * H + unit


@functools.lru_cache(maxsize=None)
def _rows_on(kind: str, H: int, device: torch.device) -> torch.Tensor:
    return gate_rows(kind, H).to(device)


def pack_wh(wh: torch.Tensor, kind: str) -> torch.Tensor:
    """``(H, G)`` recurrent kernel → the kernel's ``(G, H)`` contiguous
    ``W_hᵀ`` with rows in :func:`gate_rows` order."""
    H = wh.shape[0]
    return wh.t()[_rows_on(kind, H, wh.device)].contiguous()


def unpack_wh(wp: torch.Tensor, kind: str) -> torch.Tensor:
    """Inverse of :func:`pack_wh`: ``(G, H)`` packed → ``(H, G)``."""
    H = wp.shape[1]
    wh = wp.new_empty((H, wp.shape[0]))
    wh[:, _rows_on(kind, H, wp.device)] = wp.t()
    return wh

