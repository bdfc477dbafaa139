"""The DSP kernels' partitions, replayed on the CPU (``ops/frames_layout.py``).

``csrc/frame_window.cu`` stages each tile's signal span in shared memory and
writes the tile's output run in 16-byte vectors with a scalar head and tail;
``csrc/overlap_add.cu`` sums V outputs a thread, reading each term as V
contiguous frame elements through the frames' strides (0 included). Here
the same integer arithmetic runs in numpy, for the vocode path's shapes at
a reduced signal length, the JAX package's test shapes and the edges
(n < fl/2, fl < hop, fl not a multiple of 8, nf not a multiple of the tile,
a frame too wide for one block, rows off 16-byte alignment), in f32 and
bf16, with the tensors' addresses moved off 16-byte alignment. Each case
checks that every output element is written once, that it reads the right
sample (or zero) and window value, or the right frame elements in the
order r = 0 … R−1, that every 16-byte access is aligned, and that an output
built through the replay equals the plain twin bit for bit. The kernels
themselves are held against the twins on the card
(``tests/test_torch_cuda.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops import frames_layout as fl_
from percivaltts_tpu_torch.ops.frames_cuda import frame_window_reference, overlap_add_reference
from percivaltts_tpu_torch.ops.stft import hann_window

DTYPES = [torch.float32, torch.bfloat16]

# (B, n, frame length, hop, windowed): the vocode path's framings at n = 4000
# (YIN's fl 804, CheapTrick's fl 800, the noise STFT's windowed fl 160),
# Griffin-Lim's windowed fl 400 (R = 5) at B = 1, 4, 8 (the mel vocoder's
# chunk is 4), the JAX package's test shapes, then the edges
FRAME_CASES = [(4, 4000, 804, 80, False), (4, 4000, 800, 80, False), (1, 4000, 160, 80, True),
               (1, 16000, 400, 80, True), (4, 16000, 400, 80, True), (8, 16000, 400, 80, True),
               (4, 4000, 160, 80, False), (2, 777, 320, 64, True), (2, 1000, 400, 80, False),
               (1, 5, 160, 80, True), (2, 3001, 777, 100, True), (3, 1001, 804, 80, False),
               (2, 1041, 160, 80, True), (2, 1000, 48, 80, True), (2, 1003, 66, 100, False),
               (1, 50000, 20000, 4000, True)]
# (x_addr, w_addr, out_addr) in elements: aligned, and each off 16 bytes
ADDRS = [(0, 0, 0), (1, 3, 5)]


def _signal(B, n, dtype, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, n)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("addrs", ADDRS, ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,n,fl,hop,windowed", FRAME_CASES)
def test_frame_window_partition(B, n, fl, hop, windowed, dtype, addrs):
    x_addr, w_addr, out_addr = addrs
    item = torch.finfo(dtype).bits // 8
    V = fl_.vec(item)
    nf = -(-n // hop)
    plan = fl_.frame_window_plan(B, n, fl, hop, item, windowed, x_addr, w_addr, out_addr)
    t = plan.tiling

    # every output element written exactly once
    assert np.array_equal(np.bincount(plan.out_index, minlength=B * nf * fl), np.ones(B * nf * fl))
    # ... reading sample i·hop + j − fl/2 of its row (a staged 0 outside the signal)
    b, rest = np.divmod(plan.out_index, nf * fl)
    i, j = np.divmod(rest, fl)
    want = i * hop + j - fl // 2
    assert np.array_equal(plan.row, b)
    assert np.array_equal(plan.sample, np.where((want >= 0) & (want < n), want, -1))
    assert np.array_equal(plan.window_index, j if windowed else np.full_like(j, -1))
    # 16-byte stores, cp.async chunks and shared-memory loads all aligned
    assert (plan.store_addr % V == 0).all()
    assert plan.vector_store.sum() == V * plan.store_addr.size
    assert (plan.chunk_src % V == 0).all() and (plan.chunk_dst % 16 == 0).all()
    assert plan.chunk_in_signal.all()
    assert (plan.lds_addr % plan.lds_width == 0).all()
    assert t.smem_bytes <= fl_.FW_SMEM_BYTES
    # the span is read once a tile: ~(1 + fl / (F·hop)) reads a sample, not fl / hop
    assert plan.signal_reads <= B * n * (1 + fl / (t.F * hop)) + B * (fl + t.F * hop)

    x = _signal(B, n, dtype, seed=n + fl)
    w = hann_window(fl).to(dtype) if windowed else None
    got = fl_.frame_window_mirror(x, fl, hop, w, x_addr, w_addr, out_addr)
    assert torch.equal(got, frame_window_reference(x, fl, hop, w))


@pytest.mark.parametrize("fl", [804, 800])
def test_frame_window_vocoder_shapes_take_the_wide_path(fl):
    """At the vocoder's f32 framings (fl 804 / 800, hop 80, aligned tensors)
    no vector crosses a frame, no store is scalar, and no shared-memory load
    is narrower than 8 bytes (fl/2 = 402 puts the span 8 bytes off)."""
    plan = fl_.frame_window_plan(4, 4000, fl, 80, 4, False)
    assert plan.vector_store.all()
    assert (plan.lds_width >= (8 if fl == 804 else 16)).all()
    assert plan.lds_width.size == plan.store_addr.size  # one load a vector: none steps


def test_frame_window_tiling():
    """F = 8 frames a tile at the vocoder's shapes: 768 blocks at (4, 122880)
    and 192 at (1, 122880); B·nf past 65,535 stays one grid axis; a span
    past 48 KB lowers F; a frame too wide for one block is cut into slices."""
    assert fl_.frame_tiling(4, 122880, 804, 80, 4, False).blocks == 768
    assert fl_.frame_tiling(1, 122880, 160, 80, 4, True).blocks == 192
    t = fl_.frame_tiling(43, 122880, 160, 80, 4, False)
    assert t.blocks == 43 * 192 and 43 * 1536 > 65535
    t = fl_.frame_tiling(1, 200000, 4096, 2048, 4, True)
    assert 1 < t.F < 8 and t.J == 4096 and t.smem_bytes <= fl_.FW_SMEM_BYTES
    t = fl_.frame_tiling(1, 50000, 20000, 4000, 2, True)
    assert t.F == 1 and t.slices == -(-20000 // t.J) > 1 and t.smem_bytes <= fl_.FW_SMEM_BYTES


# (B, nf, frame length, hop, out_length or None for nf·hop): the noise
# iSTFT at 200 frames, Griffin-Lim's iSTFT (fl 400) at B = 1, 4, 8, the test
# shapes, then the edges
OLA_CASES = [(4, 200, 160, 80, None), (1, 200, 160, 80, None), (1, 200, 400, 80, None),
             (4, 200, 400, 80, None), (8, 200, 400, 80, None), (2, 13, 320, 64, None),
             (2, 257, 400, 80, None), (1, 1, 160, 80, None), (2, 37, 777, 100, None),
             (3, 41, 126, 63, None), (2, 20, 48, 80, None), (3, 50, 160, 80, 3999)]


def _ola_terms(B, nf, fl, hop, out_length, bs, fs):
    """Each output's frame elements from the definition, in order r = 0 … R−1."""
    R = -(-fl // hop)
    q = np.arange(B * out_length)
    b, s = np.divmod(q, out_length)
    t, c = np.divmod(s + fl // 2, hop)
    r = np.arange(R)
    i, col = t[:, None] - r, r * hop + c[:, None]
    ok = (i >= 0) & (i < nf) & (col < fl)
    return np.where(ok, b[:, None] * bs + i * fs + col, -1)


def _frames(B, nf, fl, dtype, layout, seed):
    """(frames view, its contiguous copy): contiguous, cut from a wider
    buffer (frame and batch strides past the frames), or a stride-0
    broadcast row (the iSTFT's window² normaliser)."""
    rng = np.random.default_rng(seed)
    if layout == "broadcast":
        row = torch.from_numpy(rng.normal(size=fl).astype(np.float32)).to(dtype)
        view = row.expand(B, nf, fl)
    elif layout == "cut":
        wide = torch.from_numpy(rng.normal(size=(B, nf + 3, fl + 7)).astype(np.float32)).to(dtype)
        view = wide[:, 2:2 + nf, 3:3 + fl]
    else:
        view = torch.from_numpy(rng.normal(size=(B, nf, fl)).astype(np.float32)).to(dtype)
    return view, view.contiguous()


@pytest.mark.parametrize("layout", ["contiguous", "cut", "broadcast"])
@pytest.mark.parametrize("out_addr", [0, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nf,fl,hop,out_length", OLA_CASES)
def test_overlap_add_partition(B, nf, fl, hop, out_length, dtype, out_addr, layout):
    out_length = out_length or nf * hop
    item = torch.finfo(dtype).bits // 8
    V = fl_.vec(item)
    frames, dense = _frames(B, nf, fl, dtype, layout, seed=nf + fl)
    bs, fs = frames.stride(0), frames.stride(1)
    plan = fl_.overlap_add_plan(B, nf, fl, hop, out_length, item, bs, fs, out_addr,
                                frames_addr=0)
    t = plan.tiling
    total = B * out_length
    assert np.array_equal(np.bincount(plan.out_index, minlength=total), np.ones(total))
    assert t.head + V * t.vectors + t.tail == total and t.head < V and t.tail < V
    assert t.blocks * fl_.OLA_THREADS * -(-t.vectors // (t.blocks * fl_.OLA_THREADS)) >= t.vectors
    want = _ola_terms(B, nf, fl, hop, out_length, bs, fs)
    assert np.array_equal(plan.terms, want[plan.out_index])
    assert ((plan.store_addr % V) == 0).all()
    assert (plan.load_addr % plan.load_width == 0).all()

    got = fl_.overlap_add_mirror(frames, hop, out_length, out_addr)
    assert torch.equal(got, overlap_add_reference(dense, hop, out_length))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4, 1])
def test_overlap_add_vocoder_shapes_take_the_wide_path(dtype, B):
    """At the noise iSTFT's shape (fl 160, hop 80, aligned), every output
    leaves in a 16-byte store and every term is one 16-byte load, the
    stride-0 normaliser row too; the grid fills the card: 960 blocks of 128
    at (4, 1536, 160) in f32 and 240 at (1, 1536, 160)."""
    item = torch.finfo(dtype).bits // 8
    for bs, fs in ((200 * 160, 160), (0, 0)):
        plan = fl_.overlap_add_plan(B, 200, 160, 80, 200 * 80, item, bs, fs)
        assert plan.vector_store.all() and (plan.load_width == 16).all()
    blocks = fl_.ola_tiling(B, 1536 * 80, item).blocks
    assert blocks == B * 1536 * 80 // fl_.vec(item) // fl_.OLA_THREADS
    if dtype == torch.float32:
        assert blocks == (960 if B == 4 else 240)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_griffin_lim_shapes_take_the_wide_path(dtype, B):
    """Griffin-Lim's framing and overlap-adds (fl 400, hop 80, aligned
    tensors): every store a 16-byte vector, every shared-memory load and
    every overlap-add term (the frames and the stride-0 window² row) a
    16-byte load; 8-frame tiles, B·1536/8 framing blocks at 1536 frames."""
    item = torch.finfo(dtype).bits // 8
    plan = fl_.frame_window_plan(B, 200 * 80, 400, 80, item, True)
    assert plan.tiling.F == 8 and plan.tiling.slices == 1
    assert plan.vector_store.all() and (plan.lds_width == 16).all()
    assert fl_.frame_tiling(B, 1536 * 80, 400, 80, item, True).blocks == B * 1536 // 8
    for bs, fs in ((200 * 400, 400), (0, 0)):
        plan = fl_.overlap_add_plan(B, 200, 400, 80, 200 * 80, item, bs, fs)
        assert plan.vector_store.all() and (plan.load_width == 16).all()
