"""Fused bidirectional LSTM, forward and BPTT: the CUDA kernels, their plain
twins, and the autograd function that pairs them.

Counterpart of ``percivaltts_tpu/ops/lstm_pallas.py`` (``_fwd_kernel`` /
``_bilstm_fwd_pallas``, ``_bwd_kernel`` / ``_bilstm_bwd_pallas``, the
``bilstm_core`` custom VJP, ``bilstm_pallas``). Same time-major
``(T, B, 4H)`` gate layout, gate order i, f, g, o, f32 carries, ``h``
rounded to the compute dtype before the recurrent product, and ``dz``
rounded to it before it is stored and multiplied.

``bilstm_fwd`` and ``bilstm_bwd`` dispatch on where their tensors lie: CUDA
tensors launch a kernel (or raise), CPU tensors take
``bilstm_fwd_reference`` / ``bilstm_bwd_reference``. There is no other
fallback. On CUDA the forward has seven routes, chosen before the launch
from dtype and width (``ops/mma_layout.py::fwd_route``): bf16 with H
a multiple of 16 up to 128 launches the tensor-core kernel
``csrc/bilstm_fwd_mma.cu``; bf16 past H = 128 up to 608 the tensor-core
cluster kernel ``csrc/bilstm_fwd_wide_mma.cu`` (``ops/wide_mma_layout.py``);
bf16 past H = 608 up to 1536 the streamed tensor-core cluster kernel
``csrc/bilstm_fwd_wide_mma_stream.cu`` (``"wide_mma_stream"``: the
tensor-core split with the W_hᵀ slice streamed from L2 in chunks,
``wide_mma_layout.pack_wh_stream``, :func:`stream_fwd_plan`); f32 past
H = 256 (which one block a direction cannot hold) up to 512 the
f32 cluster kernel ``csrc/bilstm_fwd_wide_f32.cu`` (``"wide_f32"``,
``ops/wide_f32_layout.py``); f32 past 512 and wider bf16 the CUDA-core
cluster kernel ``csrc/bilstm_fwd_wide.cu`` (``ops/wide_layout.py``; H up
to 4096); f32 up to H = 256 the f32 cluster kernel
``csrc/bilstm_fwd_narrow_f32.cu`` (``"narrow_f32"``,
``ops/narrow_f32_layout.py``); everything else ``csrc/bilstm_fwd.cu``. The
BPTT takes the same route (``bwd_route``), but bf16 past 1536 up to 4096
the streamed kernel's deep layout:
``csrc/bilstm_bwd_mma.cu``, ``csrc/bilstm_bwd_wide_mma.cu``,
``csrc/bilstm_bwd_wide_mma_stream.cu`` (:func:`stream_plan`; up to 1536 both
passes read one packing, past it the BPTT its own, 32 k a chunk),
``csrc/bilstm_bwd_wide_f32.cu``,
``csrc/bilstm_bwd_narrow_f32.cu``, ``csrc/bilstm_bwd_wide.cu`` or
``csrc/bilstm_bwd.cu``; at B <= 8 the ``"wide_f32"`` launcher takes its
few-row kernels (``csrc/wide_f32_few.cuh``, :func:`wide_f32_plan`).
``csrc/bilstm_bwd.cu`` and the ``"narrow_f32"`` kernels take H a multiple of
8, the ``"wide_mma"``, ``"wide_mma_stream"`` and ``"wide_f32"`` kernels of
32: other widths are
zero-padded to one (:func:`at_width`), which changes no real unit.
The launchers (:func:`fwd_launch`, :func:`bwd_launch`) refuse a route
they do not take (``FWD_ROUTES``, ``BWD_ROUTES``) before they build or
touch the card.
``bilstm_core`` is the differentiable entry: it runs the forward kernel,
and the BPTT kernel in the backward pass. The forward is also the
registered operator ``percival::bilstm_fwd``, which ``bilstm_fwd`` calls
while ``torch.export`` traces, so that an exported graph launches it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from percivaltts_tpu_torch.ops import narrow_f32_layout, wide_f32_layout, wide_layout, wide_mma_layout
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route, pack_wh

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the routes the launchers take (ops/mma_layout.py::fwd_route / bwd_route):
# the same for both passes
FWD_ROUTES = ("mma", "simt", "wide_mma", "wide_mma_stream", "wide", "wide_f32", "narrow_f32")
BWD_ROUTES = FWD_ROUTES
_ROWS = (1, 2, 4, 8)  # batch rows per block the kernels are instantiated for
# the CUDA-core BPTT's dz·W_hᵀ reduction runs on whole warps of its 4H
# threads: H a multiple of 8, other widths zero-padded to one
SIMT_BWD_GRANULE = 8


def _gates(z: torch.Tensor, H: int):
    i, f, g, o = z.split(H, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells: bool = False):
    """Plain PyTorch twin of the forward kernel: ``(T, B, 4H)`` input gates
    per direction and ``(H, 4H)`` recurrent kernels → ``(y_f, y_b)`` (and
    ``(c_f, c_b)`` when ``with_cells``), each ``(T, B, H)`` in the compute
    dtype. ``y_b[t]`` is the backward direction's state at frame t."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    T, B, G = gx_f.shape
    H = G // 4
    dt = gx_f.dtype
    outs = []
    for gx, wh, steps in ((gx_f, wh_f, range(T)), (gx_b, wh_b, range(T - 1, -1, -1))):
        w = wh.float()
        h = gx.new_zeros((B, H), dtype=torch.float32)
        c = torch.zeros_like(h)
        ys, cs = [], []
        for t in steps:
            z = gx[t].float() + h.to(dt).float() @ w
            i, f, g, o = _gates(z, H)
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys.append(h.to(dt))
            cs.append(c.to(dt))
        if steps.step < 0:
            ys.reverse()
            cs.reverse()
        outs.append((torch.stack(ys), torch.stack(cs)))
    (yf, cf), (yb, cb) = outs
    return (yf, yb, cf, cb) if with_cells else (yf, yb)


def bilstm_bwd_reference(gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b,
                         c_f, c_b, dy_f, dy_b):
    """Plain PyTorch twin of the BPTT kernel (``_bwd_kernel``): the saved
    input gates and recurrent kernels, the previous states ``hp`` / ``cp``
    (t−1 for the forward direction, t+1 for the backward one), the cells
    ``c`` and the output gradients ``dy`` (each ``(T, B, H)``) →
    ``(dgx_f, dgx_b)``, ``(T, B, 4H)`` in the compute dtype. Gates are
    recomputed from ``gx + hp·W_h``; dh and dc are carried in f32."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    _check_states(gx_f, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b)
    T, B, G = gx_f.shape
    H = G // 4
    dt = gx_f.dtype
    outs = []
    for gx, wh, hp, cp, cs, dy, steps in (
        (gx_f, wh_f, hp_f, cp_f, c_f, dy_f, range(T - 1, -1, -1)),
        (gx_b, wh_b, hp_b, cp_b, c_b, dy_b, range(T)),
    ):
        w = wh.float()
        dh_carry = gx.new_zeros((B, H), dtype=torch.float32)
        dc_carry = torch.zeros_like(dh_carry)
        dgx = torch.empty_like(gx)
        for t in steps:
            z = gx[t].float() + hp[t].float() @ w
            i, f, g, o = _gates(z, H)
            c, cprev = cs[t].float(), cp[t].float()
            tc = torch.tanh(c)
            dh = dy[t].float() + dh_carry
            dc = dc_carry + dh * o * (1.0 - tc * tc)
            dz = torch.cat([
                dc * g * i * (1.0 - i),
                dc * cprev * f * (1.0 - f),
                dc * i * (1.0 - g * g),
                dh * tc * o * (1.0 - o),
            ], dim=-1).to(dt)
            dgx[t] = dz
            dh_carry = dz.float() @ w.T
            dc_carry = dc * f
        outs.append(dgx)
    return outs[0], outs[1]


def _check_shapes(gx_f, gx_b, wh_f, wh_b) -> None:
    if gx_f.dim() != 3 or gx_f.shape[-1] % 4 or min(gx_f.shape) < 1:
        raise ValueError(f"gx_f must be (T, B, 4H) with T, B, H >= 1, got {tuple(gx_f.shape)}")
    H = gx_f.shape[-1] // 4
    if gx_b.shape != gx_f.shape:
        raise ValueError(f"gx_b {tuple(gx_b.shape)} != gx_f {tuple(gx_f.shape)}")
    for name, w in (("wh_f", wh_f), ("wh_b", wh_b)):
        if tuple(w.shape) != (H, 4 * H):
            raise ValueError(f"{name} must be ({H}, {4 * H}), got {tuple(w.shape)}")
    dts = {t.dtype for t in (gx_f, gx_b, wh_f, wh_b)}
    if len(dts) != 1 or gx_f.dtype not in _DTYPE_CODES:
        raise TypeError(f"the BiLSTM takes one dtype of float32/bfloat16, got {dts}")


def _check_states(gx_f, *states) -> None:
    T, B, G = gx_f.shape
    for s in states:
        if tuple(s.shape) != (T, B, G // 4):
            raise ValueError(f"states must be {(T, B, G // 4)}, got {tuple(s.shape)}")
        if s.dtype != gx_f.dtype:
            raise TypeError(f"states must be {gx_f.dtype}, got {s.dtype}")


def _one_device(name: str, tensors, entry: str = "ops.lstm_cuda.bilstm_core") -> torch.device:
    """The one device of ``tensors``; raises on several devices, on a device
    other than cuda/cpu, and on non-contiguous CUDA tensors or CUDA tensors
    that require a gradient under grad mode (a kernel's output carries no
    graph: the differentiable entry is ``entry``)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous CUDA inputs")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} launches a kernel without an autograd graph; inputs that "
            f"require a gradient go through {entry}"
        )
    return device


def rows_per_block(B: int, n_sm: int) -> int:
    """Batch rows per block: the smallest tile whose grid (2 directions ×
    ceil(B / rows) blocks) still fits one wave of the card's SMs — a smaller
    tile means a shorter sequential step — else the largest tile."""
    for r in _ROWS:
        if 2 * -(-B // r) <= n_sm:
            return r
    return _ROWS[-1]


def _launch_geometry(device, B: int, H: int):
    if 4 * H > 1024:  # one thread per gate column
        raise ValueError(f"the CUDA BiLSTM takes H <= 256, got H={H}")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return rows_per_block(B, n_sm), torch.cuda.current_stream(device).cuda_stream


def pad_gates(t: torch.Tensor, Hp: int, gates: int) -> torch.Tensor:
    """``(..., gates·H)`` → ``(..., gates·Hp)``: each gate block zero-padded
    from H to Hp units (``gates=1``: a ``(..., H)`` state or bias)."""
    H = t.shape[-1] // gates
    return F.pad(t.unflatten(-1, (gates, H)), (0, Hp - H)).flatten(-2)


def at_width(fn, Hp: int, gates: int, *args, **kw):
    """``fn(*args, **kw)`` run at ``Hp >= H`` units: every argument
    zero-padded (``(H, gates·H)`` recurrent kernels in their rows and each
    gate block, ``(…, gates·H)`` gates in each block, ``(…, H)`` states and
    biases), every output cut back to H.

    Exact for both cells: a padded unit's gates see z = 0 (zero gates, zero
    W_h columns), so the LSTM's c = 0.5·0 + 0.5·tanh(0) = 0 and h = 0, the
    GRU's n = tanh(0) = 0 and h = 0.5·0; zero W_h rows feed nothing back;
    in the BPTT its dh, dc and dz stay 0."""
    H = args[2].shape[0]
    if Hp == H:
        return fn(*args, **kw)

    def pad(t):
        if t.dim() == 2:
            return F.pad(pad_gates(t, Hp, gates), (0, 0, 0, Hp - H)).contiguous()
        return pad_gates(t, Hp, gates if t.shape[-1] == gates * H else 1).contiguous()

    def cut(t):
        if t is None:
            return None
        n = gates if t.shape[-1] == gates * Hp else 1
        return t.unflatten(-1, (n, Hp))[..., :H].flatten(-2).contiguous()

    return tuple(cut(t) for t in fn(*map(pad, args), **kw))


def _wide_mma_check(dtype: torch.dtype, H: int, gates: int) -> None:
    """Raise unless the tensor-core cluster kernels take ``dtype`` and ``H``."""
    if dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core wide kernels take bfloat16, got {dtype}")
    if not wide_mma_layout.fits(H, gates):
        raise ValueError(f"the tensor-core wide {wide_mma_layout.CELLS[gates]} kernels take "
                         f"H <= {wide_mma_layout.max_h(gates)}, got H={H}")


def _wide_mma_stream_check(dtype: torch.dtype, H: int, gates: int, what: str = "BPTT") -> None:
    """Raise unless the streamed tensor-core cluster kernels (``what``:
    ``"BPTT"`` or ``"forward"``) take ``dtype`` and ``H``: bf16, the forward
    up to ``wide_mma_layout.stream_fwd_max_h`` (1536 / 1792), the BPTT up to
    ``stream_bwd_max_h`` (4096, on its deep layout past the forward's
    widths): the two passes' limits part until the forward's redesign."""
    if dtype != torch.bfloat16:
        raise TypeError(f"the streamed tensor-core wide {what}s take bfloat16, got {dtype}")
    fwd = what == "forward"
    if not (wide_mma_layout.stream_fits if fwd else wide_mma_layout.stream_bwd_fits)(H, gates):
        limit = (wide_mma_layout.stream_fwd_max_h if fwd else wide_mma_layout.stream_bwd_max_h)
        raise ValueError(f"the streamed tensor-core wide {wide_mma_layout.CELLS[gates]} {what}s "
                         f"take H <= {limit(gates)}, got H={H}")


def stream_args(wh_f, wh_b, gates: int, chunk: int = wide_mma_layout.CHUNK) -> tuple:
    """Both directions' ``W_hᵀ`` packed per block and chunk for the streamed
    kernels (``wide_mma_layout.pack_wh_stream``) and the split they share:
    at 64 k a chunk the forward's and the BPTT's 64-k layout's packing, at 32
    (``DEEP_CHUNK``) the BPTT's deep layout's (the forward does not run
    there: each pass gets its own until the forward's redesign)."""
    p = wide_mma_layout.plan(wh_f.shape[0], gates)
    return (wide_mma_layout.pack_wh_stream(wh_f, p, chunk),
            wide_mma_layout.pack_wh_stream(wh_b, p, chunk)), p


def stream_scratch(sp: wide_mma_layout.StreamPlan, B: int, device) -> torch.Tensor | None:
    """The streamed BPTT's scratch for a launch of ``B`` rows on plan ``sp``:
    in the deep layout the dh partials of its 2·ceil(B / R) clusters
    (``sp.scratch`` bytes each, uninitialised: every slot is written before
    it is read); None in the 64-k layout, which keeps them on chip."""
    if not sp.scratch:
        return None
    return torch.empty(2 * -(-B // sp.R) * sp.scratch, dtype=torch.uint8, device=device)


def count_stream(wrapper, kind: str, B: int, H: int, device: int) -> None:
    """Add a ``"wide_mma_stream"`` BPTT launch of ``B`` rows at width ``H``
    to ``wrapper.stream_layouts`` by the layout its plan takes: ``"64k"``
    (64-k chunks, some resident) or ``"deep"`` (32-k chunks, all streamed)."""
    sp = stream_plan(kind, B, wide_mma_layout.padded(H), device)
    wrapper.stream_layouts["deep" if sp.chunk == wide_mma_layout.DEEP_CHUNK else "64k"] += 1


def _wide_f32_check(dtype: torch.dtype, H: int, gates: int, what: str = "BPTT") -> None:
    """Raise unless the f32 cluster kernels (``what``: ``"BPTT"`` or
    ``"forward"``) take ``dtype`` and ``H``."""
    if dtype != torch.float32:
        raise TypeError(f"the f32 wide {what} kernels take float32, got {dtype}")
    fwd = what == "forward"
    if not (wide_f32_layout.fwd_fits if fwd else wide_f32_layout.fits)(H, gates):
        low = wide_f32_layout.FWD_MIN_H[gates] - 1 if fwd else 2 * wide_f32_layout.CHUNK
        raise ValueError(f"the f32 wide {wide_layout.CELLS[gates]} {what} kernels take "
                         f"{low} < H <= {wide_f32_layout.max_h(gates)}, got H={H}")


def check_route(route: str, routes: tuple, what: str) -> None:
    """Raise ``ValueError`` naming ``routes`` unless ``route`` is one of them."""
    if route not in routes:
        raise ValueError(f"{what} takes the routes {', '.join(map(repr, routes))}, "
                         f"not {route!r}")


def _narrow_f32_check(dtype: torch.dtype, H: int, gates: int, what: str = "BPTT") -> None:
    """Raise unless the f32 narrow kernels (``what``: ``"BPTT"`` or
    ``"forward"``) take ``dtype`` and ``H``."""
    if dtype != torch.float32:
        raise TypeError(f"the f32 narrow {what} kernels take float32, got {dtype}")
    if not narrow_f32_layout.fits(H, gates):
        raise ValueError(f"the f32 narrow {wide_layout.CELLS[gates]} {what} kernels take "
                         f"H <= {narrow_f32_layout.MAX_H[gates]}, got H={H}")


@functools.lru_cache(maxsize=None)
def narrow_f32_plan(kind: str, B: int, H: int, blocks: int = 0, rows: int = 0,
                    device: int = 0) -> narrow_f32_layout.Plan:
    """The launch plan ``percival_{kind}_bwd_narrow_f32_plan`` gives ``B`` rows
    at width ``H`` (a multiple of 8) on card ``device`` (``kind``:
    ``"bilstm"`` or ``"bigru"``; ``blocks`` / ``rows``: its overrides, 0 for
    the plan's own choice); raises when none fits."""
    from percivaltts_tpu_torch import _build

    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        fn = getattr(_build.library(), f"percival_{kind}_bwd_narrow_f32_plan")
        _build.check(fn(B, H, blocks, rows, out), f"{kind} narrow f32 BPTT plan at B={B} H={H}")
    return narrow_f32_layout.Plan(*out)


@functools.lru_cache(maxsize=None)
def narrow_f32_fwd_plan(kind: str, B: int, H: int, blocks: int = 0, rows: int = 0,
                        resident: int = -1, device: int = 0) -> narrow_f32_layout.Plan:
    """The forward's launch plan, ``percival_{kind}_fwd_narrow_f32_plan``, as
    :func:`narrow_f32_plan`; ``resident``: 1 / 0 forces W_h in registers / in
    shared memory (-1: the plan's choice)."""
    from percivaltts_tpu_torch import _build

    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device):
        fn = getattr(_build.library(), f"percival_{kind}_fwd_narrow_f32_plan")
        _build.check(fn(B, H, blocks, rows, resident, out),
                     f"{kind} narrow f32 forward plan at B={B} H={H}")
    return narrow_f32_layout.Plan(*out)


@functools.lru_cache(maxsize=None)
def wide_f32_plan(kind: str, B: int, H: int, rows: int = 0,
                  device: int = 0) -> wide_f32_layout.BwdPlan:
    """The ``"wide_f32"`` BPTT's launch plan, ``percival_{kind}_bwd_wide_f32_plan``,
    for ``B`` rows at width ``H`` (a multiple of 32) on card ``device``
    (``kind``: ``"bilstm"`` or ``"bigru"``; ``rows``: R forced, 1, 2 or 4 the
    few-row kernels, 8, 16 or 24 the chunked ones, 0 the plan's choice);
    raises when none fits."""
    from percivaltts_tpu_torch import _build

    p = wide_layout.plan(H, 4 if kind == "bilstm" else 3)
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device):
        fn = getattr(_build.library(), f"percival_{kind}_bwd_wide_f32_plan")
        _build.check(fn(B, H, p.Hb, p.U, rows, out),
                     f"{kind} f32 wide BPTT plan at B={B} H={H} rows={rows}")
    return wide_f32_layout.BwdPlan(*out)


@functools.lru_cache(maxsize=None)
def stream_plan(kind: str, B: int, H: int, device: int = 0) -> wide_mma_layout.StreamPlan:
    """The streamed BPTT's launch plan, ``percival_{kind}_bwd_wide_mma_stream_plan``,
    for ``B`` rows at width ``H`` (a multiple of 32) on card ``device``
    (``kind``: ``"bilstm"`` or ``"bigru"``): the 64-k layout or, past
    ``wide_mma_layout.stream_max_h``, the deep one; raises when none fits."""
    from percivaltts_tpu_torch import _build

    p = wide_mma_layout.plan(H, 4 if kind == "bilstm" else 3)
    out = (ctypes.c_int * 14)()
    with torch.cuda.device(device):
        fn = getattr(_build.library(), f"percival_{kind}_bwd_wide_mma_stream_plan")
        _build.check(fn(B, H, p.Hb, p.U, out), f"{kind} streamed BPTT plan at B={B} H={H}")
    return wide_mma_layout.StreamPlan(*out)


@functools.lru_cache(maxsize=None)
def stream_fwd_plan(kind: str, B: int, H: int, rows: int = 0,
                    device: int = 0) -> wide_mma_layout.StreamFwdPlan:
    """The streamed forward's launch plan, ``percival_{kind}_fwd_wide_mma_stream_plan``,
    for ``B`` rows at width ``H`` (a multiple of 32) on card ``device``
    (``kind``: ``"bilstm"`` or ``"bigru"``; ``rows``: R forced, 0 the plan's
    choice); raises when none fits."""
    from percivaltts_tpu_torch import _build

    p = wide_mma_layout.plan(H, 4 if kind == "bilstm" else 3)
    out = (ctypes.c_int * 11)()
    with torch.cuda.device(device):
        fn = getattr(_build.library(), f"percival_{kind}_fwd_wide_mma_stream_plan")
        _build.check(fn(B, H, p.Hb, p.U, rows, out),
                     f"{kind} streamed forward plan at B={B} H={H} rows={rows}")
    return wide_mma_layout.StreamFwdPlan(*out)


def count_wide_f32(wrapper, kind: str, B: int, H: int, device: int) -> None:
    """Add a ``"wide_f32"`` BPTT launch of ``B`` rows at width ``H`` to
    ``wrapper.wide_f32_plans`` by the kernel its plan launches: ``"few"``
    (R <= 4, ``csrc/wide_f32_few.cuh``) or ``"chunked"``."""
    R = wide_f32_plan(kind, B, wide_f32_layout.padded(H), 0, device).R
    wrapper.wide_f32_plans["few" if R <= 4 else "chunked"] += 1


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data is not 16-byte aligned: the
    tensor-core kernels stream their (T, B, ·) inputs with 16-byte
    ``cp.async`` copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fwd_launch(route: str, gx_f, gx_b, wh_f, wh_b, with_cells: bool = False, rows: int = 0,
               blocks: int = 0, resident: int = -1):
    """Launch the forward kernel of ``route`` (one of ``FWD_ROUTES``:
    ``"mma"``, ``"simt"``, ``"wide_mma"``, ``"wide_mma_stream"``, ``"wide"``,
    ``"wide_f32"`` or ``"narrow_f32"``;
    any other raises ``ValueError`` before anything is built or launched)
    on CUDA inputs that :func:`bilstm_fwd` has checked; counts nothing.
    ``bilstm_fwd`` is the entry; ``chip_smoke.py`` times one route's kernel
    beside another's through this. ``"wide_mma"`` (bf16 only, H up to
    ``wide_mma_layout.max_h(4)``, else ``ValueError``) runs H that is not a
    multiple of 32 zero-padded to one (:func:`at_width`), at ``rows`` rows a
    cluster when given (a measurement's override; 0: the plan's choice,
    ``wide_mma_layout.fwd_rows``), and so does ``"wide_mma_stream"`` (bf16
    only, H up to ``wide_mma_layout.stream_fwd_max_h(4)``, else ``ValueError``
    naming it; 0: the plan's choice, ``wide_mma_layout.stream_fwd_plan``,
    :func:`stream_fwd_plan`);
    ``"narrow_f32"`` (f32 only, H up to 256)
    H that is not a multiple of 8, over at most ``blocks`` blocks a cluster,
    at ``rows`` rows and with W_h in registers (``resident=1``) or shared
    memory (0) when given (a measurement's overrides; 0 / -1: the plan's
    choice, :func:`narrow_f32_fwd_plan`); ``"wide_f32"`` (f32 only, H up to
    ``wide_f32_layout.max_h(4)``) H that is not a multiple of 32; ``"wide"``
    raises ``ValueError`` past ``wide_layout.MAX_H``, ``"simt"`` past
    H = 256."""
    check_route(route, FWD_ROUTES, "bilstm_fwd")
    from percivaltts_tpu_torch import _build

    device = gx_f.device
    T, B, G = gx_f.shape
    H = G // 4
    granule = {"wide_mma": wide_mma_layout.K_GRANULE,
               "wide_mma_stream": wide_mma_layout.K_GRANULE,
               "wide_f32": wide_f32_layout.K_GRANULE,
               "narrow_f32": narrow_f32_layout.K_GRANULE}.get(route)
    if route == "wide_mma":
        _wide_mma_check(gx_f.dtype, H, 4)
    if route == "wide_mma_stream":
        _wide_mma_stream_check(gx_f.dtype, H, 4, "forward")
    if route == "wide_f32":
        _wide_f32_check(gx_f.dtype, H, 4, "forward")
    if route == "narrow_f32":
        _narrow_f32_check(gx_f.dtype, H, 4, "forward")
    if granule and H % granule:
        return at_width(lambda *a, **kw: fwd_launch(route, *a, **kw),
                        -(-H // granule) * granule, 4, gx_f, gx_b, wh_f, wh_b,
                        with_cells=with_cells, rows=rows, blocks=blocks, resident=resident)
    lib = _build.library()
    new = lambda: torch.empty((T, B, H), dtype=gx_f.dtype, device=device)  # noqa: E731
    yf, yb = new(), new()
    cf, cb = (new(), new()) if with_cells else (None, None)
    cells = (cf.data_ptr(), cb.data_ptr()) if with_cells else (None, None)
    with torch.cuda.device(device):
        if route == "mma":
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch: a temporary freed earlier could
            # hand its memory to the next one before the kernel reads it
            ins = (aligned16(gx_f), aligned16(gx_b), pack_wh(wh_f, "lstm"), pack_wh(wh_b, "lstm"))
            err = lib.percival_bilstm_fwd_mma(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(), *cells,
                T, B, H, stream,
            )
        elif route == "wide_mma":
            p = wide_mma_layout.plan(H, 4)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (aligned16(gx_f), aligned16(gx_b), wide_mma_layout.pack_wh(wh_f, p),
                   wide_mma_layout.pack_wh(wh_b, p))  # held (see above)
            err = lib.percival_bilstm_fwd_wide_mma(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(), *cells,
                T, B, H, p.Hb, p.U, rows, stream,
            )
        elif route == "wide_mma_stream":
            packed, p = stream_args(wh_f, wh_b, 4)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (aligned16(gx_f), aligned16(gx_b), *packed)  # held (see above)
            err = lib.percival_bilstm_fwd_wide_mma_stream(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(), *cells,
                T, B, H, p.Hb, p.U, rows, stream,
            )
        elif route == "narrow_f32":
            p = narrow_f32_fwd_plan("bilstm", B, H, blocks, rows, resident, device.index)
            s = narrow_f32_layout.Split(*p[:4])
            stream = torch.cuda.current_stream(device).cuda_stream
            # W_h in registers: W_h itself (one block's packing is the identity)
            ins = (wh_f, wh_b) if p.resident else (
                narrow_f32_layout.pack_wh(wh_f, s), narrow_f32_layout.pack_wh(wh_b, s))  # held
            err = lib.percival_bilstm_fwd_narrow_f32(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                yf.data_ptr(), yb.data_ptr(), *cells, T, B, H, p.Hb, p.U, p.R, p.resident,
                stream,
            )
        elif route == "wide_f32":
            p = wide_layout.plan(H)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))  # held (see above)
            err = lib.percival_bilstm_fwd_wide_f32(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                yf.data_ptr(), yb.data_ptr(), *cells, T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide":
            p = wide_layout.plan(H)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))  # held (see above)
            err = lib.percival_bilstm_fwd_wide(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                yf.data_ptr(), yb.data_ptr(), *cells,
                T, B, H, p.Hb, p.U, _DTYPE_CODES[gx_f.dtype], stream,
            )
        else:
            rows, stream = _launch_geometry(device, B, H)
            err = lib.percival_bilstm_fwd(
                gx_f.data_ptr(), gx_b.data_ptr(), wh_f.data_ptr(), wh_b.data_ptr(),
                yf.data_ptr(), yb.data_ptr(), *cells,
                T, B, H, _DTYPE_CODES[gx_f.dtype], rows, stream,
            )
    _build.check(err, f"bilstm_fwd launch ({route})")
    return (yf, yb, cf, cb) if with_cells else (yf, yb)


def _bilstm_fwd_cuda(gx_f, gx_b, wh_f, wh_b, with_cells: bool = False):
    """The CUDA kernel of ``percival::bilstm_fwd``: checks, the route, one
    launch, one count on ``bilstm_fwd.launches`` and its route's entry of
    ``bilstm_fwd.routes``."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    _one_device("bilstm_fwd", (gx_f, gx_b, wh_f, wh_b))
    route = fwd_route(gx_f.dtype, gx_f.shape[-1] // 4, "lstm", gx_f.shape[1])
    out = fwd_launch(route, gx_f, gx_b, wh_f, wh_b, with_cells)
    bilstm_fwd.launches += 1
    bilstm_fwd.routes[route] += 1
    return list(out)


# The forward kernel as a registered operator, which a graph that
# ``torch.export`` traces holds; the graph's calls launch through the same
# CUDA function as eager code and the autograd pair, counts included (eager
# calls skip the dispatcher: see ops/frames_cuda.py). CPU tensors take the
# twin; the fake kernel checks the arguments and gives the outputs' shapes.
# Mixed devices reach the CUDA function, which refuses them.
torch.library.define(
    "percival::bilstm_fwd",
    "(Tensor gx_f, Tensor gx_b, Tensor wh_f, Tensor wh_b, bool with_cells) -> Tensor[]",
)
torch.library.impl("percival::bilstm_fwd", "CUDA", _bilstm_fwd_cuda)
torch.library.impl("percival::bilstm_fwd", "CPU",
                   lambda *args: list(bilstm_fwd_reference(*args)))


@torch.library.register_fake("percival::bilstm_fwd")
def _bilstm_fwd_fake(gx_f, gx_b, wh_f, wh_b, with_cells=False):
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    T, B, G = gx_f.shape
    return [gx_f.new_empty((T, B, G // 4)) for _ in range(4 if with_cells else 2)]


def bilstm_fwd(gx_f, gx_b, wh_f, wh_b, with_cells: bool = False):
    """Both LSTM directions over precomputed input gates, in one launch; the
    operator ``percival::bilstm_fwd`` while ``torch.export`` traces.

    CUDA tensors launch a hand-written kernel: the tensor-core one for bf16
    with H a multiple of 16 up to 128, the tensor-core cluster one for bf16
    past 128 up to 608, the streamed tensor-core cluster one for bf16 past
    608 up to 1536, the f32 cluster one for f32 past 256 up to 512, the
    CUDA-core cluster one past those (f32: 512, bf16: 1536), the f32 narrow
    one for f32 up to 256, else the one-block CUDA-core one
    (:func:`~percivaltts_tpu_torch.ops.mma_layout.fwd_route`); CPU tensors
    run :func:`bilstm_fwd_reference`. Raises on mixed devices, another dtype
    than float32/bfloat16, a shape mismatch, H past ``wide_layout.MAX_H``
    on CUDA, non-contiguous CUDA inputs, CUDA inputs that require a gradient
    under grad mode, or a launch error.
    Every launch adds one to ``bilstm_fwd.launches`` and to its route's
    entry of ``bilstm_fwd.routes``, also from inside an exported graph."""
    args = (gx_f, gx_b, wh_f, wh_b, with_cells)
    if torch.compiler.is_exporting():
        return tuple(torch.ops.percival.bilstm_fwd(*args))
    if any(t.is_cuda for t in args[:4]):
        return tuple(_bilstm_fwd_cuda(*args))
    return bilstm_fwd_reference(*args)


bilstm_fwd.launches = 0
bilstm_fwd.routes = {"mma": 0, "simt": 0, "wide": 0, "wide_mma": 0, "wide_mma_stream": 0,
                     "wide_f32": 0, "narrow_f32": 0}


def bwd_launch(route: str, gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b,
               dy_f, dy_b, blocks: int = 0, rows: int = 0):
    """Launch the BPTT kernel of ``route`` (one of ``BWD_ROUTES``: ``"mma"``,
    ``"wide_mma"``, ``"wide_mma_stream"``, ``"wide_f32"``, ``"narrow_f32"``,
    ``"wide"`` or ``"simt"``; any other raises ``ValueError`` before
    anything is built or launched) on CUDA inputs that :func:`bilstm_bwd`
    has checked; counts nothing.
    ``bilstm_bwd`` is the entry; ``chip_smoke.py`` times one route's kernel
    beside another's through this. ``"simt"`` and ``"narrow_f32"`` (f32
    only, H up to 256, else ``ValueError``) run H that is not a multiple of
    8, and ``"wide_mma"`` (bf16 only, H up to ``wide_mma_layout.max_h(4)``),
    ``"wide_mma_stream"`` (bf16 only, H up to
    ``wide_mma_layout.stream_bwd_max_h(4)``, else ``ValueError`` naming it;
    past ``stream_max_h(4)`` on the deep layout) and
    ``"wide_f32"`` (f32 only, H up to ``wide_f32_layout.max_h(4)``) H
    that is not a multiple of 32, zero-padded to one (:func:`at_width`).
    ``"narrow_f32"`` splits over at most ``blocks`` blocks a cluster and
    takes ``rows`` rows when given (a measurement's overrides; 0: the plan's
    choice, :func:`narrow_f32_plan`); ``"wide_f32"`` takes ``rows`` rows
    when given (1, 2, 4: the few-row kernels; 8, 16, 24: the chunked ones;
    0: the plan's choice, :func:`wide_f32_plan`)."""
    check_route(route, BWD_ROUTES, "bilstm_bwd")
    from percivaltts_tpu_torch import _build

    device = gx_f.device
    T, B, G = gx_f.shape
    H = G // 4
    states = (hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b)
    granule = {"simt": SIMT_BWD_GRANULE, "wide_mma": wide_mma_layout.K_GRANULE,
               "wide_mma_stream": wide_mma_layout.K_GRANULE,
               "wide_f32": wide_f32_layout.K_GRANULE,
               "narrow_f32": narrow_f32_layout.K_GRANULE}.get(route)
    if route == "wide_mma":
        _wide_mma_check(gx_f.dtype, H, 4)
    if route == "wide_mma_stream":
        _wide_mma_stream_check(gx_f.dtype, H, 4)
    if route == "wide_f32":
        _wide_f32_check(gx_f.dtype, H, 4)
    if route == "narrow_f32":
        _narrow_f32_check(gx_f.dtype, H, 4)
    if granule and H % granule:
        Hp = -(-H // granule) * granule
        return at_width(lambda *a: bwd_launch(route, *a, blocks=blocks, rows=rows), Hp, 4,
                        gx_f, gx_b, wh_f, wh_b, *states)
    lib = _build.library()
    dgx_f, dgx_b = torch.empty_like(gx_f), torch.empty_like(gx_b)
    with torch.cuda.device(device):
        if route == "mma":
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), aligned16(wh_f), aligned16(wh_b),
                   pack_wh(wh_f, "lstm"), pack_wh(wh_b, "lstm"), *map(aligned16, states))
            err = lib.percival_bilstm_bwd_mma(
                *(t.data_ptr() for t in ins), dgx_f.data_ptr(), dgx_b.data_ptr(), T, B, H, stream,
            )
        elif route == "wide_mma":
            p = wide_mma_layout.plan(H, 4)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), wide_mma_layout.pack_wh(wh_f, p),
                   wide_mma_layout.pack_wh(wh_b, p), *map(aligned16, states))
            err = lib.percival_bilstm_bwd_wide_mma(
                *(t.data_ptr() for t in ins), dgx_f.data_ptr(), dgx_b.data_ptr(),
                T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide_mma_stream":
            sp = stream_plan("bilstm", B, H, device.index)
            packed, p = stream_args(wh_f, wh_b, 4, sp.chunk)
            scratch = stream_scratch(sp, B, device)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), *packed, *map(aligned16, states))
            err = lib.percival_bilstm_bwd_wide_mma_stream(
                *(t.data_ptr() for t in ins), dgx_f.data_ptr(), dgx_b.data_ptr(),
                None if scratch is None else scratch.data_ptr(), T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide_f32":
            p = wide_layout.plan(H)
            R = wide_f32_plan("bilstm", B, H, rows, device.index).R
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (gx_f, gx_b, wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p),
                   aligned16(hp_f), aligned16(hp_b), cp_f, cp_b, c_f, c_b, dy_f, dy_b)
            err = lib.percival_bilstm_bwd_wide_f32(
                *(t.data_ptr() for t in ins), dgx_f.data_ptr(), dgx_b.data_ptr(),
                T, B, H, p.Hb, p.U, R, stream,
            )
        elif route == "narrow_f32":
            p = narrow_f32_plan("bilstm", B, H, blocks, rows, device.index)
            s = narrow_f32_layout.Split(*p[:4])
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (gx_f, gx_b, narrow_f32_layout.pack_wh(wh_f, s),
                   narrow_f32_layout.pack_wh(wh_b, s), aligned16(hp_f), aligned16(hp_b),
                   cp_f, cp_b, c_f, c_b, dy_f, dy_b)
            err = lib.percival_bilstm_bwd_narrow_f32(
                *(t.data_ptr() for t in ins), dgx_f.data_ptr(), dgx_b.data_ptr(),
                T, B, H, p.Hb, p.U, p.R, stream,
            )
        elif route == "wide":
            p = wide_layout.plan(H)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see fwd_launch)
            ins = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))
            err = lib.percival_bilstm_bwd_wide(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in states), dgx_f.data_ptr(), dgx_b.data_ptr(),
                T, B, H, p.Hb, p.U, _DTYPE_CODES[gx_f.dtype], stream,
            )
        else:
            rows, stream = _launch_geometry(device, B, H)
            err = lib.percival_bilstm_bwd(
                *(t.data_ptr() for t in (gx_f, gx_b, wh_f, wh_b, *states)),
                dgx_f.data_ptr(), dgx_b.data_ptr(),
                T, B, H, _DTYPE_CODES[gx_f.dtype], rows, stream,
            )
    _build.check(err, f"bilstm_bwd launch ({route})")
    return dgx_f, dgx_b


def bilstm_bwd(gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b):
    """BPTT for both directions in one launch → ``(dgx_f, dgx_b)``.

    Arguments as :func:`bilstm_bwd_reference`. CUDA tensors launch a
    hand-written kernel: the tensor-core one for bf16 with H a multiple of
    16 up to 128, the tensor-core cluster one for bf16 past 128 up to 608,
    the streamed tensor-core cluster one for bf16 past 608 up to 4096 (on
    its deep layout past 1536), the
    f32 cluster one for f32 past 256 up to 512 (its few-row kernels at
    B <= 8), the CUDA-core cluster one for f32 past 512,
    the f32 narrow cluster one for f32 up
    to 256, else the one-block CUDA-core one, H not a multiple of 8
    zero-padded to one
    (:func:`~percivaltts_tpu_torch.ops.mma_layout.bwd_route`); CPU tensors
    run the twin. Raises on
    mixed devices, dtypes, or shapes, non-contiguous CUDA inputs, CUDA
    inputs that require a gradient under grad mode, H past
    ``wide_layout.MAX_H``, or a launch error. Every launch adds one to
    ``bilstm_bwd.launches`` and to its route's entry of
    ``bilstm_bwd.routes``; a ``"wide_f32"`` launch also to its kernel's
    entry of ``bilstm_bwd.wide_f32_plans`` (``"few"`` or ``"chunked"``), a
    ``"wide_mma_stream"`` one to its layout's entry of
    ``bilstm_bwd.stream_layouts`` (``"64k"`` or ``"deep"``)."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    states = (hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b)
    _check_states(gx_f, *states)
    device = _one_device("bilstm_bwd", (gx_f, gx_b, wh_f, wh_b, *states))
    if device.type == "cpu":
        return bilstm_bwd_reference(gx_f, gx_b, wh_f, wh_b, *states)
    route = bwd_route(gx_f.dtype, gx_f.shape[-1] // 4, "lstm", gx_f.shape[1])
    out = bwd_launch(route, gx_f, gx_b, wh_f, wh_b, *states)
    bilstm_bwd.launches += 1
    bilstm_bwd.routes[route] += 1
    if route == "wide_f32":
        count_wide_f32(bilstm_bwd, "bilstm", gx_f.shape[1], gx_f.shape[-1] // 4, device.index)
    if route == "wide_mma_stream":
        count_stream(bilstm_bwd, "bilstm", gx_f.shape[1], gx_f.shape[-1] // 4, device.index)
    return out


bilstm_bwd.launches = 0
bilstm_bwd.routes = {"mma": 0, "simt": 0, "wide": 0, "wide_mma": 0, "wide_mma_stream": 0,
                     "wide_f32": 0, "narrow_f32": 0}
# the "wide_f32" launches by the kernel their plan took (count_wide_f32)
bilstm_bwd.wide_f32_plans = {"chunked": 0, "few": 0}
# the "wide_mma_stream" launches by the layout their plan took (count_stream)
bilstm_bwd.stream_layouts = {"64k": 0, "deep": 0}


class BiLSTMFunction(torch.autograd.Function):
    """The forward kernel with the BPTT kernel as its backward (the
    ``bilstm_core`` custom VJP, ``lstm_pallas.py:364-400``). ``fwd`` / ``bwd``
    are the kernel wrappers or their plain twins. The backward is first
    order only: the gradient penalty's double backward runs through the
    critic, never through the generator."""

    @staticmethod
    def forward(ctx, gx_f, gx_b, wh_f, wh_b, fwd, bwd):
        yf, yb, cf, cb = fwd(gx_f, gx_b, wh_f, wh_b, with_cells=True)
        ctx.save_for_backward(gx_f, gx_b, wh_f, wh_b, yf, yb, cf, cb)
        ctx.bwd = bwd
        return yf, yb

    @staticmethod
    @once_differentiable
    def backward(ctx, dyf, dyb):
        gx_f, gx_b, wh_f, wh_b, yf, yb, cf, cb = ctx.saved_tensors
        # an output that fed nothing has no gradient; the slices of the
        # (T, B, 2H) concatenation arrive non-contiguous
        dyf = torch.zeros_like(yf) if dyf is None else dyf.contiguous()
        dyb = torch.zeros_like(yb) if dyb is None else dyb.contiguous()
        z = torch.zeros_like(yf[:1])
        # "previous" state per direction: t-1 for fwd, t+1 for bwd
        hp_f = torch.cat([z, yf[:-1]])
        cp_f = torch.cat([z, cf[:-1]])
        hp_b = torch.cat([yb[1:], z])
        cp_b = torch.cat([cb[1:], z])
        dgx_f, dgx_b = ctx.bwd(gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b,
                               cf, cb, dyf, dyb)
        # dW_h = Σ_t h_prevᵀ·dz: one (H, T·B)×(T·B, 4H) GEMM outside the kernel
        H = wh_f.shape[0]
        dwh_f = hp_f.reshape(-1, H).T @ dgx_f.reshape(-1, 4 * H)
        dwh_b = hp_b.reshape(-1, H).T @ dgx_b.reshape(-1, 4 * H)
        return dgx_f, dgx_b, dwh_f.to(wh_f.dtype), dwh_b.to(wh_b.dtype), None, None


def bilstm_core(gx_f, gx_b, wh_f, wh_b, fwd=bilstm_fwd, bwd=bilstm_bwd):
    """The recurrence, differentiable: through :class:`BiLSTMFunction` when
    grad mode is on and an input requires a gradient, else ``fwd`` alone."""
    args = (gx_f, gx_b, wh_f, wh_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return BiLSTMFunction.apply(*args, fwd, bwd)
    return fwd(*args)


def bilstm_core_reference(gx_f, gx_b, wh_f, wh_b):
    """:func:`bilstm_core` on the plain twins of both kernels."""
    return bilstm_core(gx_f, gx_b, wh_f, wh_b, bilstm_fwd_reference, bilstm_bwd_reference)


def input_gates(xt, wi, b):
    """``xt @ W_i + b``: ``(T, B, D)`` time-major input → ``(T, B, G)`` input
    gates. The layers make ``x`` time-major before the GEMM, so that the
    gates come out in the kernels' ``(T, B, G)`` layout and only the narrow
    input is transposed (at B = 160, T = 512, H = 512 the gates are 8× its
    bytes); each gate is the same product and sum as ``(x @ W_i + b)``'s."""
    return xt @ wi + b


def bilstm(x, wi_f, wh_f, b_f, wi_b, wh_b, b_b, core=bilstm_core):
    """``(B, T, D)`` → ``(B, T, 2H)`` fused bidirectional LSTM
    (``bilstm_pallas``). The input projections ``x @ W_i + b`` are plain
    GEMMs outside the recurrence, as in the JAX package
    (:func:`input_gates`); ``core`` runs the recurrence (tests and the smoke
    run substitute the plain twins)."""
    xt = x.transpose(0, 1).contiguous()  # (T, B, D)
    gx_f, gx_b = input_gates(xt, wi_f, b_f), input_gates(xt, wi_b, b_b)  # (T, B, 4H)
    yf, yb = core(gx_f, gx_b, wh_f.contiguous(), wh_b.contiguous())
    return torch.cat([yf, yb], dim=-1).transpose(0, 1)
