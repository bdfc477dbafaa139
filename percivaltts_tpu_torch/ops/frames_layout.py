"""The DSP kernels' partitions, on the CPU.

``csrc/frame_window.cu`` and ``csrc/overlap_add.cu`` split their work in
ways the plain twins do not: tiles of frames with a staged signal span,
16-byte vectors with scalar heads and tails, loads as wide as an address
allows, and frames read through strides (0 included). This module replays
that integer arithmetic in plain Python/numpy, element by element, so the
CPU tests can check that every output element is written once, that it
reads the sample (or the frame slices, in order) the function asks for, and
that every 16-byte access is aligned; and it builds outputs through the
replay, which must equal the twins bit for bit. It plays the role
``ops/mma_layout.py`` plays for the recurrences; nothing on a path calls it.

Addresses are modelled as an element index modulo V (16 bytes in elements:
4 in f32, 8 in bf16): ``x_addr``, ``w_addr``, ``out_addr`` and
``frames_addr`` stand for ``tensor.data_ptr() // itemsize``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

VEC_BYTES = 16  # one st.global.v4 / ld.shared.v4
FW_FRAMES = 8  # F: frames a tile
FW_SMEM_BYTES = 48 * 1024
OLA_THREADS = 128
OLA_BLOCKS_PER_SM = 2048 // OLA_THREADS


def vec(itemsize: int) -> int:
    """Elements in 16 bytes: V."""
    return VEC_BYTES // itemsize


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _roundup(a: int, m: int) -> int:
    return _cdiv(a, m) * m


def _widest(byte_addr: np.ndarray) -> np.ndarray:
    """The widest of 16, 8, 4, 2 bytes that divides each address: the load
    width ``lds_vec`` / ``ldg_vec`` picks."""
    out = np.full(byte_addr.shape, 2, np.int64)
    for w in (4, 8, 16):
        out[byte_addr % w == 0] = w
    return out


# --- framing × window ----------------------------------------------------------


@dataclass(frozen=True)
class FrameTiling:
    F: int  # frames a tile
    J: int  # columns a tile (fl unless a frame is cut into slices)
    slices: int
    tiles_row: int
    blocks: int
    smem_bytes: int


def _smem_elems(F: int, J: int, hop: int, V: int, windowed: bool) -> int:
    xs = _roundup(V - 1 + (F - 1) * hop + J, V)
    return xs + (_roundup(V - 1 + J, V) if windowed else 0)


def frame_tiling(B: int, n: int, fl: int, hop: int, itemsize: int, windowed: bool) -> FrameTiling:
    """The launcher's choice: F = 8 frames a tile, fewer while the tile's
    span and window pass 48 KB, and a frame cut into column slices when even
    one does not fit."""
    V = vec(itemsize)
    budget = FW_SMEM_BYTES // itemsize
    F, J = FW_FRAMES, fl
    while F > 1 and _smem_elems(F, J, hop, V, windowed) > budget:
        F -= 1
    if _smem_elems(F, J, hop, V, windowed) > budget:
        J = (budget // (2 if windowed else 1) - 3 * V) // V * V
    slices = _cdiv(fl, J)
    tiles_row = _cdiv(_cdiv(n, hop), F) * slices
    return FrameTiling(F, J, slices, tiles_row, tiles_row * B,
                       _smem_elems(F, J, hop, V, windowed) * itemsize)


@dataclass
class FramePlan:
    tiling: FrameTiling
    out_index: np.ndarray  # flat index into (B, nf, fl) of every store, in store order
    row: np.ndarray  # the signal row each store reads
    sample: np.ndarray  # the signal sample it reads, -1 for a staged zero
    window_index: np.ndarray  # the window element it multiplies by (-1: no window)
    vector_store: np.ndarray  # True where the element leaves in a 16-byte store
    store_addr: np.ndarray  # element address of each 16-byte store
    chunk_src: np.ndarray  # element address of each cp.async source chunk
    chunk_dst: np.ndarray  # shared-memory byte offset of each cp.async destination
    chunk_in_signal: np.ndarray  # the chunk's V samples lie inside their source
    lds_addr: np.ndarray  # shared-memory byte offset of each vector load
    lds_width: np.ndarray  # its width in bytes
    signal_reads: int  # samples staged from the signal, over all tiles


def _stage_map(src_addr: int, n: int, s0: int, span: int, V: int):
    """``stage()``: pad, the source index of staged slots [pad, pad+span)
    (-1 where a zero is written), and the cp.async chunks (slot, source
    index) covering whole 16-byte chunks inside the source."""
    pad = (src_addr % V + s0) % V
    k = np.arange(pad, pad + span)
    s = s0 - pad + k
    src = np.where((s >= 0) & (s < n), s, -1)
    lo, hi = max(pad, pad - s0), min(pad + span, n - s0 + pad)
    c_lo, c_hi = _cdiv(lo, V), (hi // V if hi > 0 else 0)
    chunks = np.arange(c_lo, c_hi) * V if c_hi > c_lo else np.zeros(0, np.int64)
    return pad, src, chunks, chunks + s0 - pad


def frame_window_plan(B: int, n: int, fl: int, hop: int, itemsize: int, windowed: bool,
                      x_addr: int = 0, w_addr: int = 0, out_addr: int = 0) -> FramePlan:
    """Every store of ``frame_window_kernel``, tile by tile, as the kernel
    computes it: the staged span and window, the run's head / vectors /
    tail, each vector's (frame, column) from one division, contiguous reads
    inside a frame and element-by-element stepping across a boundary."""
    V = vec(itemsize)
    t = frame_tiling(B, n, fl, hop, itemsize, windowed)
    nf = _cdiv(n, hop)
    ws = _roundup(V - 1 + t.J, V) if windowed else 0  # s_x starts after the window slot
    parts = {k: [] for k in ("out", "row", "sample", "widx", "vec", "store", "csrc", "cdst",
                             "cin", "lds")}
    signal_reads = 0
    for tile in range(t.blocks):
        b, it = divmod(tile, t.tiles_row)
        group, sl = divmod(it, t.slices)
        i0, j0 = group * t.F, sl * t.J
        nfr, Jt = min(t.F, nf - i0), min(t.J, fl - j0)
        span = (nfr - 1) * hop + Jt
        s0 = i0 * hop - fl // 2 + j0
        pad, x_src, chunks, chunk_src = _stage_map(x_addr + b * n, n, s0, span, V)
        signal_reads += int((x_src >= 0).sum())
        parts["csrc"].append(x_addr + b * n + chunk_src)
        parts["cdst"].append((ws + chunks) * itemsize)
        parts["cin"].append((chunk_src >= 0) & (chunk_src + V <= n))
        if windowed:
            pad_w, w_src, wchunks, wchunk_src = _stage_map(w_addr, fl, j0, Jt, V)
            parts["csrc"].append(w_addr + wchunk_src)
            parts["cdst"].append(wchunks * itemsize)
            parts["cin"].append((wchunk_src >= 0) & (wchunk_src + V <= fl))

        R0 = (b * nf + i0) * fl + j0
        L = nfr * Jt
        head = min(L, (V - (out_addr + R0) % V) % V)
        nv = (L - head) // V
        tail = L - head - nv * V
        q = head + np.arange(nv) * V
        f, j = q // Jt, q % Jt
        inside = j + V <= Jt
        fe, je = np.empty((nv, V), np.int64), np.empty((nv, V), np.int64)
        fs, js = f.copy(), j.copy()  # the crossing vectors step element by element
        for e in range(V):
            fe[:, e] = np.where(inside, f, fs)
            je[:, e] = np.where(inside, j + e, js)
            js += 1
            wrap = js == Jt
            fs[wrap] += 1
            js[wrap] = 0
        parts["store"].append(out_addr + R0 + q)
        parts["lds"].append((ws + pad + f[inside] * hop + j[inside]) * itemsize)
        if windowed:
            parts["lds"].append((pad_w + j[inside]) * itemsize)
        qs = np.concatenate([np.arange(head), head + nv * V + np.arange(tail)])
        f_all = np.concatenate([fe.ravel(), qs // Jt])
        j_all = np.concatenate([je.ravel(), qs % Jt])
        q_all = np.concatenate([(q[:, None] + np.arange(V)).ravel(), qs])
        parts["vec"].append(np.arange(q_all.size) < nv * V)
        k = pad + f_all * hop + j_all  # the s_x slot each element reads
        if not ((k >= pad) & (k < pad + span)).all():
            raise AssertionError("a read outside the staged span")
        parts["out"].append(R0 + q_all)
        parts["row"].append(np.full(q_all.size, b))
        parts["sample"].append(x_src[k - pad])
        parts["widx"].append(w_src[j_all] if windowed else np.full(q_all.size, -1))
    cat = {k: np.concatenate(v) if v else np.zeros(0, np.int64) for k, v in parts.items()}
    return FramePlan(t, cat["out"], cat["row"], cat["sample"], cat["widx"],
                     cat["vec"].astype(bool), cat["store"], cat["csrc"], cat["cdst"],
                     cat["cin"].astype(bool), cat["lds"], _widest(cat["lds"]), signal_reads)


def frame_window_mirror(x: torch.Tensor, frame_length: int, hop: int, window=None,
                        x_addr: int = 0, w_addr: int = 0, out_addr: int = 0) -> torch.Tensor:
    """``(B, n)`` → ``(B, nf, fl)`` built store by store through
    :func:`frame_window_plan`: the staged sample (or 0) times the staged
    window value, one f32 product rounded to the dtype."""
    B, n = x.shape
    plan = frame_window_plan(B, n, frame_length, hop, x.element_size(), window is not None,
                             x_addr, w_addr, out_addr)
    rows = torch.from_numpy(plan.row)
    samples = torch.from_numpy(plan.sample)
    v = torch.where(samples >= 0, x[rows, samples.clamp(min=0)], torch.zeros((), dtype=x.dtype))
    if window is not None:
        v = (v.float() * window[torch.from_numpy(plan.window_index)].float()).to(x.dtype)
    out = torch.zeros(B * _cdiv(n, hop) * frame_length, dtype=x.dtype)
    out[torch.from_numpy(plan.out_index)] = v
    return out.view(B, _cdiv(n, hop), frame_length)


# --- overlap-add ---------------------------------------------------------------


@dataclass(frozen=True)
class OlaTiling:
    head: int
    vectors: int
    tail: int
    blocks: int


def ola_tiling(B: int, out_length: int, itemsize: int, out_addr: int = 0,
               sms: int = 132) -> OlaTiling:
    """The launcher's split of the flattened ``(B·out_length)`` output: a
    scalar head to 16-byte alignment, V-wide vectors, a scalar tail; one
    vector a thread of 128, at most 16 blocks an SM (a grid-stride loop past
    that)."""
    V = vec(itemsize)
    total = B * out_length
    head = min(total, (V - out_addr % V) % V)
    nv = (total - head) // V
    blocks = max(1, min(_cdiv(nv, OLA_THREADS), sms * OLA_BLOCKS_PER_SM))
    return OlaTiling(head, nv, total - head - nv * V, blocks)


@dataclass
class OlaPlan:
    tiling: OlaTiling
    out_index: np.ndarray  # flat output index of every store, in store order
    terms: np.ndarray  # (stores, R): element offset of term r into the frames' storage, -1 if none
    vector_store: np.ndarray
    store_addr: np.ndarray  # element address of each 16-byte store
    load_addr: np.ndarray  # byte address of each vector load of V frame elements
    load_width: np.ndarray


def overlap_add_plan(B: int, nf: int, fl: int, hop: int, out_length: int, itemsize: int,
                     batch_stride: int, frame_stride: int, out_addr: int = 0,
                     frames_addr: int = 0, sms: int = 132) -> OlaPlan:
    """Every store of ``overlap_add_kernel``: each vector's row, hop block
    and column from two divisions; when its V outputs share a row and a
    block, each term r is V contiguous frame elements (one load as wide as
    the address allows, or element by element where the frame ends inside
    the vector); otherwise each output sums its own terms."""
    V, R = vec(itemsize), _cdiv(fl, hop)
    t = ola_tiling(B, out_length, itemsize, out_addr, sms)
    half = fl // 2

    def one(qe):  # sum_one(): each output's terms in order r = 0 … R−1
        b, s = qe // out_length, qe % out_length
        p = s + half
        tb, c = p // hop, p % hop
        r = np.arange(R)
        i, col = tb[:, None] - r, r * hop + c[:, None]
        ok = (i >= 0) & (i < nf) & (col < fl)
        return np.where(ok, b[:, None] * batch_stride + i * frame_stride + col, -1)

    q = t.head + np.arange(t.vectors) * V
    b, s = q // out_length, q % out_length
    p = s + half
    tb, c = p // hop, p % hop
    fast = (s + V <= out_length) & (c + V <= hop)
    terms = np.full((t.vectors, V, R), -1, np.int64)
    loads = []
    for r in range(R):
        i, col = tb - r, r * hop + c
        ok = fast & (i >= 0) & (i < nf) & (col < fl)
        base = b * batch_stride + i * frame_stride + col
        loads.append(frames_addr + base[ok & (col + V <= fl)])
        for e in range(V):
            terms[:, e, r] = np.where(ok & (col + e < fl), base + e, -1)
    slow = np.nonzero(~fast)[0]
    if slow.size:
        qe = (q[slow, None] + np.arange(V)).ravel()
        terms[slow] = one(qe).reshape(slow.size, V, R)
    qs = np.concatenate([np.arange(t.head), t.head + t.vectors * V + np.arange(t.tail)])
    out_index = np.concatenate([(q[:, None] + np.arange(V)).ravel(), qs])
    all_terms = np.concatenate([terms.reshape(-1, R), one(qs)])
    load_addr = np.concatenate(loads) * itemsize if loads else np.zeros(0, np.int64)
    return OlaPlan(t, out_index, all_terms, np.arange(out_index.size) < t.vectors * V,
                   out_addr + q, load_addr, _widest(load_addr))


def overlap_add_mirror(frames: torch.Tensor, hop: int, out_length: int, out_addr: int = 0,
                       sms: int = 132) -> torch.Tensor:
    """``(B, nf, fl)`` (any strides, last axis contiguous) → ``(B,
    out_length)`` built store by store through :func:`overlap_add_plan`:
    the terms read from the frames' storage in order r = 0 … R−1, each sum
    rounded to the dtype."""
    B, nf, fl = frames.shape
    if frames.stride(-1) != 1:
        raise ValueError("the kernel reads frames whose last axis is contiguous")
    storage = torch.as_strided(frames, (frames.untyped_storage().nbytes() // frames.element_size()
                                        - frames.storage_offset(),), (1,))
    addr = frames.data_ptr() // frames.element_size()
    plan = overlap_add_plan(B, nf, fl, hop, out_length, frames.element_size(), frames.stride(0),
                            frames.stride(1), out_addr, addr, sms)
    terms = torch.from_numpy(plan.terms)
    acc = torch.zeros(terms.shape[0], dtype=torch.float32)
    for r in range(terms.shape[1]):
        ok = terms[:, r] >= 0
        v = storage[terms[:, r].clamp(min=0)].float()
        acc = torch.where(ok, (acc + v).to(frames.dtype).float(), acc)
    out = torch.zeros(B * out_length, dtype=frames.dtype)
    out[torch.from_numpy(plan.out_index)] = acc.to(frames.dtype)
    return out.view(B, out_length)
