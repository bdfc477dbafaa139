"""Fused bidirectional GRU, forward and BPTT: the CUDA kernels, their plain
twins, and the autograd function that pairs them.

Counterpart of the GRU half of ``percivaltts_tpu/ops/lstm_pallas.py``
(``_gru_fwd_kernel`` / ``_bigru_fwd_pallas``, ``_gru_bwd_kernel`` /
``_bigru_bwd_pallas``, the ``bigru_core`` custom VJP, ``bigru_pallas``).
flax ``GRUCell`` math, gate order r, z, n, over hoisted input gates
``gx = x·W_i + b`` (time-major ``(T, B, 3H)``)::

    r = σ(gx_r + h·W_hr),  z = σ(gx_z + h·W_hz)
    n = tanh(gx_n + r ⊙ (h·W_hn + b_hn)),  h' = (1 − z) ⊙ n + z ⊙ h

with an f32 carry and ``h`` rounded to the compute dtype before the
recurrent product. The BPTT reads the previous state from the saved
outputs ``y`` (so in the compute dtype), and rounds d(gates) and
``dnr = dn_pre·r`` to the compute dtype before they are stored or fed back.

``bigru_fwd`` and ``bigru_bwd`` dispatch on where their tensors lie: CUDA
tensors launch a kernel (or raise), CPU tensors take ``bigru_fwd_reference``
/ ``bigru_bwd_reference``. There is no other fallback. On CUDA the forward
has seven routes, chosen before the launch from dtype and width
(``ops/mma_layout.py::fwd_route``): bf16 with H a multiple of 16 up to 128
launches the tensor-core kernel ``csrc/bigru_fwd_mma.cu``; bf16 past
H = 128 up to 672 the tensor-core cluster kernel
``csrc/bigru_fwd_wide_mma.cu`` (``ops/wide_mma_layout.py``); bf16 past
H = 672 up to 1792 the streamed tensor-core cluster kernel
``csrc/bigru_fwd_wide_mma_stream.cu`` (``"wide_mma_stream"``,
``lstm_cuda.stream_fwd_plan``); f32 past
H = 320 (which one block a direction cannot hold) up to 512 the f32 cluster
kernel ``csrc/bigru_fwd_wide_f32.cu`` (``"wide_f32"``,
``ops/wide_f32_layout.py``); f32 past 512 and wider bf16 the CUDA-core
cluster kernel ``csrc/bigru_fwd_wide.cu`` (``ops/wide_layout.py``; H up to
4096); f32 up to H = 320 the f32 cluster kernel
``csrc/bigru_fwd_narrow_f32.cu`` (``"narrow_f32"``,
``ops/narrow_f32_layout.py``); everything else ``csrc/bigru_fwd.cu``. The
BPTT takes the same route (``bwd_route``), but bf16 past 1792 up to 4096
the streamed kernel's deep layout: ``csrc/bigru_bwd_mma.cu``,
``csrc/bigru_bwd_wide_mma.cu``, ``csrc/bigru_bwd_wide_mma_stream.cu``
(``lstm_cuda.stream_plan``; up to 1792 both passes read one packing, past
it the BPTT its own, 32 k a chunk),
``csrc/bigru_bwd_wide_f32.cu``, ``csrc/bigru_bwd_narrow_f32.cu``,
``csrc/bigru_bwd_wide.cu`` or ``csrc/bigru_bwd.cu``; at B <= 8 the
``"wide_f32"`` launcher takes its few-row kernels (``csrc/wide_f32_few.cuh``,
``lstm_cuda.wide_f32_plan``). ``csrc/bigru_bwd.cu``, the ``"wide_mma"``,
``"wide_mma_stream"`` and ``"wide_f32"`` kernels take H a multiple of 32, the ``"narrow_f32"`` kernels
of 8: other widths are zero-padded to one (``ops/lstm_cuda.py::at_width``),
which changes no real unit. The launchers refuse a route they do not take
(``lstm_cuda.FWD_ROUTES``, ``BWD_ROUTES``) before they build or touch the
card.
``bigru_core`` is the differentiable entry: it runs the forward kernel, and
the BPTT kernel in the backward pass. The forward is also the registered operator
``percival::bigru_fwd``, which ``bigru_fwd`` calls while ``torch.export``
traces, so that an exported graph launches it.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from percivaltts_tpu_torch.ops import narrow_f32_layout, wide_f32_layout, wide_layout, wide_mma_layout
from percivaltts_tpu_torch.ops.lstm_cuda import (
    _DTYPE_CODES,
    BWD_ROUTES,
    FWD_ROUTES,
    _narrow_f32_check,
    _one_device,
    _wide_f32_check,
    _wide_mma_check,
    _wide_mma_stream_check,
    aligned16,
    at_width,
    check_route,
    count_stream,
    count_wide_f32,
    input_gates,
    narrow_f32_fwd_plan,
    narrow_f32_plan,
    rows_per_block,
    stream_args,
    stream_plan,
    stream_scratch,
    wide_f32_plan,
)
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route, pack_wh


def _gates(gh: torch.Tensor, gx: torch.Tensor, bn: torch.Tensor, H: int):
    """(r, z, n, gh_n + b_hn) from the f32 recurrent and input gates."""
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H : 2 * H] + gh[:, H : 2 * H])
    ghn = gh[:, 2 * H :] + bn
    n = torch.tanh(gx[:, 2 * H :] + r * ghn)
    return r, z, n, ghn


def bigru_fwd_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b):
    """Plain PyTorch twin of the forward kernel: ``(T, B, 3H)`` input gates
    per direction, ``(H, 3H)`` recurrent kernels and ``(H,)`` n-branch
    biases → ``(y_f, y_b)``, each ``(T, B, H)`` in the compute dtype.
    ``y_b[t]`` is the backward direction's state at frame t."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    T, B, G = gx_f.shape
    H = G // 3
    dt = gx_f.dtype
    outs = []
    for gx, wh, bn, steps in ((gx_f, wh_f, bn_f, range(T)),
                              (gx_b, wh_b, bn_b, range(T - 1, -1, -1))):
        w, b = wh.float(), bn.float()
        h = gx.new_zeros((B, H), dtype=torch.float32)
        ys = []
        for t in steps:
            _, z, n, _ = _gates(h.to(dt).float() @ w, gx[t].float(), b, H)
            h = (1.0 - z) * n + z * h
            ys.append(h.to(dt))
        if steps.step < 0:
            ys.reverse()
        outs.append(torch.stack(ys))
    return outs[0], outs[1]


def bigru_bwd_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b):
    """Plain PyTorch twin of the BPTT kernel (``_gru_bwd_kernel``): the
    saved input gates, recurrent kernels and biases, the previous states
    ``hp`` (the compute-dtype outputs at t−1 for the forward direction, t+1
    for the backward one) and the output gradients ``dy`` (each
    ``(T, B, H)``) → ``(dgx_f, dgx_b, dnr_f, dnr_b)``: ``dgx`` =
    ``[dr_pre, dz_pre, dn_pre]`` ``(T, B, 3H)`` and ``dnr = dn_pre·r``
    ``(T, B, H)``, in the compute dtype. Gates are recomputed from
    ``gx + hp·W_h``; dh is carried in f32."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    _check_states(gx_f, hp_f, hp_b, dy_f, dy_b)
    T, B, G = gx_f.shape
    H = G // 3
    dt = gx_f.dtype
    outs = []
    for gx, wh, bn, hp, dy, steps in (
        (gx_f, wh_f, bn_f, hp_f, dy_f, range(T - 1, -1, -1)),
        (gx_b, wh_b, bn_b, hp_b, dy_b, range(T)),
    ):
        w, b = wh.float(), bn.float()
        dh_carry = gx.new_zeros((B, H), dtype=torch.float32)
        dgx = torch.empty_like(gx)
        dnr_out = torch.empty_like(hp)
        for t in steps:
            hprev = hp[t].float()
            r, z, n, ghn = _gates(hprev @ w, gx[t].float(), b, H)
            dh = dy[t].float() + dh_carry
            dn_pre = dh * (1.0 - z) * (1.0 - n * n)
            dr_pre = dn_pre * ghn * r * (1.0 - r)
            dz_pre = dh * (hprev - n) * z * (1.0 - z)
            dnr = dn_pre * r
            dgx[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dt)
            dnr_out[t] = dnr.to(dt)
            dgh = torch.cat([dr_pre, dz_pre, dnr], dim=-1).to(dt)
            dh_carry = dh * z + dgh.float() @ w.T
        outs.append((dgx, dnr_out))
    (dgx_f, dnr_f), (dgx_b, dnr_b) = outs
    return dgx_f, dgx_b, dnr_f, dnr_b


def _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b) -> None:
    if gx_f.dim() != 3 or gx_f.shape[-1] % 3 or min(gx_f.shape) < 1:
        raise ValueError(f"gx_f must be (T, B, 3H) with T, B, H >= 1, got {tuple(gx_f.shape)}")
    H = gx_f.shape[-1] // 3
    if gx_b.shape != gx_f.shape:
        raise ValueError(f"gx_b {tuple(gx_b.shape)} != gx_f {tuple(gx_f.shape)}")
    for name, w in (("wh_f", wh_f), ("wh_b", wh_b)):
        if tuple(w.shape) != (H, 3 * H):
            raise ValueError(f"{name} must be ({H}, {3 * H}), got {tuple(w.shape)}")
    for name, b in (("bn_f", bn_f), ("bn_b", bn_b)):
        if tuple(b.shape) != (H,):
            raise ValueError(f"{name} must be ({H},), got {tuple(b.shape)}")
    dts = {t.dtype for t in (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)}
    if len(dts) != 1 or gx_f.dtype not in _DTYPE_CODES:
        raise TypeError(f"the BiGRU takes one dtype of float32/bfloat16, got {dts}")


def _check_states(gx_f, *states) -> None:
    T, B, G = gx_f.shape
    for s in states:
        if tuple(s.shape) != (T, B, G // 3):
            raise ValueError(f"states must be {(T, B, G // 3)}, got {tuple(s.shape)}")
        if s.dtype != gx_f.dtype:
            raise TypeError(f"states must be {gx_f.dtype}, got {s.dtype}")


# the one-block kernels: one thread per gate column (3H <= 1024); the
# CUDA-core BPTT's dgh·W_hᵀ reduction shuffles over whole warps of them: H a
# multiple of 32, other widths zero-padded to one, so up to 320. Wider
# calls take the cluster kernels (route "wide")
SIMT_MAX_H = 341
SIMT_BWD_GRANULE = 32
SIMT_BWD_MAX_H = 320


def _launch_geometry(device, B: int, H: int, name: str, limit: int):
    if H > limit:
        raise ValueError(f"the CUDA {name} takes H <= {limit}, got H={H}")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return rows_per_block(B, n_sm), torch.cuda.current_stream(device).cuda_stream


def fwd_launch(route: str, gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, rows: int = 0,
               blocks: int = 0, resident: int = -1):
    """Launch the forward kernel of ``route`` (one of
    ``lstm_cuda.FWD_ROUTES``: ``"mma"``, ``"simt"``, ``"wide_mma"``,
    ``"wide_mma_stream"``, ``"wide"``, ``"wide_f32"`` or ``"narrow_f32"``;
    any other raises ``ValueError`` before
    anything is built or launched) on CUDA inputs that :func:`bigru_fwd` has
    checked; counts nothing. ``bigru_fwd`` is the entry; ``chip_smoke.py``
    times one route's kernel beside another's through this. ``"wide_mma"``
    (bf16 only, H up to ``wide_mma_layout.max_h(3)``) runs H that is not a
    multiple of 32 zero-padded to one (``lstm_cuda.at_width``), at ``rows``
    rows a cluster when given (0: the plan's choice), and so does
    ``"wide_mma_stream"`` (bf16 only, H up to
    ``wide_mma_layout.stream_fwd_max_h(3)``); ``"narrow_f32"`` (f32
    only, H up to 320) H that is not a multiple of 8, with
    ``lstm_cuda.fwd_launch``'s overrides ``blocks``, ``rows`` and
    ``resident``; ``"wide_f32"`` (f32 only, H up to
    ``wide_f32_layout.max_h(3)``) H that is not a multiple of 32; ``"wide"``
    raises ``ValueError`` past ``wide_layout.GRU_MAX_H``, ``"simt"`` past
    H = 341."""
    check_route(route, FWD_ROUTES, "bigru_fwd")
    from percivaltts_tpu_torch import _build

    device = gx_f.device
    T, B, G = gx_f.shape
    H = G // 3
    granule = {"wide_mma": wide_mma_layout.K_GRANULE,
               "wide_mma_stream": wide_mma_layout.K_GRANULE,
               "wide_f32": wide_f32_layout.K_GRANULE,
               "narrow_f32": narrow_f32_layout.K_GRANULE}.get(route)
    if route == "wide_mma":
        _wide_mma_check(gx_f.dtype, H, 3)
    if route == "wide_mma_stream":
        _wide_mma_stream_check(gx_f.dtype, H, 3, "forward")
    if route == "wide_f32":
        _wide_f32_check(gx_f.dtype, H, 3, "forward")
    if route == "narrow_f32":
        _narrow_f32_check(gx_f.dtype, H, 3, "forward")
    if granule and H % granule:
        return at_width(lambda *a, **kw: fwd_launch(route, *a, **kw),
                        -(-H // granule) * granule, 3, gx_f, gx_b, wh_f, wh_b, bn_f, bn_b,
                        rows=rows, blocks=blocks, resident=resident)
    lib = _build.library()
    yf = torch.empty((T, B, H), dtype=gx_f.dtype, device=device)
    yb = torch.empty_like(yf)
    with torch.cuda.device(device):
        if route == "mma":
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), pack_wh(wh_f, "gru"), pack_wh(wh_b, "gru"),
                   bn_f, bn_b)
            err = lib.percival_bigru_fwd_mma(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(), T, B, H, stream,
            )
        elif route == "wide_mma":
            p = wide_mma_layout.plan(H, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (aligned16(gx_f), aligned16(gx_b), wide_mma_layout.pack_wh(wh_f, p),
                   wide_mma_layout.pack_wh(wh_b, p), bn_f, bn_b)  # held (see above)
            err = lib.percival_bigru_fwd_wide_mma(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(),
                T, B, H, p.Hb, p.U, rows, stream,
            )
        elif route == "wide_mma_stream":
            packed, p = stream_args(wh_f, wh_b, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (aligned16(gx_f), aligned16(gx_b), *packed, bn_f, bn_b)  # held (see above)
            err = lib.percival_bigru_fwd_wide_mma_stream(
                *(t.data_ptr() for t in ins), yf.data_ptr(), yb.data_ptr(),
                T, B, H, p.Hb, p.U, rows, stream,
            )
        elif route == "narrow_f32":
            p = narrow_f32_fwd_plan("bigru", B, H, blocks, rows, resident, device.index)
            s = narrow_f32_layout.Split(*p[:4])
            stream = torch.cuda.current_stream(device).cuda_stream
            # W_h in registers: W_h itself (one block's packing is the identity)
            ins = (wh_f, wh_b) if p.resident else (
                narrow_f32_layout.pack_wh(wh_f, s), narrow_f32_layout.pack_wh(wh_b, s))  # held
            err = lib.percival_bigru_fwd_narrow_f32(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                bn_f.data_ptr(), bn_b.data_ptr(), yf.data_ptr(), yb.data_ptr(),
                T, B, H, p.Hb, p.U, p.R, p.resident, stream,
            )
        elif route == "wide_f32":
            p = wide_layout.plan(H, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))  # held (see above)
            err = lib.percival_bigru_fwd_wide_f32(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                bn_f.data_ptr(), bn_b.data_ptr(), yf.data_ptr(), yb.data_ptr(),
                T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide":
            p = wide_layout.plan(H, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            ins = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))  # held (see above)
            err = lib.percival_bigru_fwd_wide(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in ins),
                bn_f.data_ptr(), bn_b.data_ptr(), yf.data_ptr(), yb.data_ptr(),
                T, B, H, p.Hb, p.U, _DTYPE_CODES[gx_f.dtype], stream,
            )
        else:
            rows, stream = _launch_geometry(device, B, H, "BiGRU", SIMT_MAX_H)
            err = lib.percival_bigru_fwd(
                *(t.data_ptr() for t in (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)),
                yf.data_ptr(), yb.data_ptr(), T, B, H, _DTYPE_CODES[gx_f.dtype], rows, stream,
            )
    _build.check(err, f"bigru_fwd launch ({route})")
    return yf, yb


def _bigru_fwd_cuda(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b):
    """The CUDA kernel of ``percival::bigru_fwd``: checks, the route, one
    launch, one count on ``bigru_fwd.launches`` and its route's entry of
    ``bigru_fwd.routes``."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    ins = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    _one_device("bigru_fwd", ins, "ops.gru_cuda.bigru_core")
    route = fwd_route(gx_f.dtype, gx_f.shape[-1] // 3, "gru", gx_f.shape[1])
    out = fwd_launch(route, *ins)
    bigru_fwd.launches += 1
    bigru_fwd.routes[route] += 1
    return out


# The forward kernel as a registered operator (as ``percival::bilstm_fwd``
# in ops/lstm_cuda.py): an exported graph holds it; CUDA tensors launch, CPU
# tensors take the twin, the fake kernel checks the arguments and gives the
# outputs' shapes.
torch.library.define(
    "percival::bigru_fwd",
    "(Tensor gx_f, Tensor gx_b, Tensor wh_f, Tensor wh_b, Tensor bn_f, Tensor bn_b)"
    " -> (Tensor, Tensor)",
)
torch.library.impl("percival::bigru_fwd", "CUDA", _bigru_fwd_cuda)
torch.library.impl("percival::bigru_fwd", "CPU", lambda *args: bigru_fwd_reference(*args))


@torch.library.register_fake("percival::bigru_fwd")
def _bigru_fwd_fake(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b):
    _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    T, B, G = gx_f.shape
    return gx_f.new_empty((T, B, G // 3)), gx_f.new_empty((T, B, G // 3))


def bigru_fwd(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b):
    """Both GRU directions over precomputed input gates, in one launch →
    ``(y_f, y_b)``; the operator ``percival::bigru_fwd`` while
    ``torch.export`` traces.

    CUDA tensors launch a hand-written kernel: the tensor-core one for bf16
    with H a multiple of 16 up to 128, the tensor-core cluster one for bf16
    past 128 up to 672, the streamed tensor-core cluster one for bf16 past
    672 up to 1792, the f32 cluster one for f32 past 320 up to 512, the
    CUDA-core cluster one past those (f32: 512, bf16: 1792), the f32 narrow
    one for f32 up to 320, else the one-block CUDA-core one
    (:func:`~percivaltts_tpu_torch.ops.mma_layout.fwd_route`); CPU tensors
    run :func:`bigru_fwd_reference`. Raises on mixed devices, another dtype
    than float32/bfloat16, a shape mismatch, H past
    ``wide_layout.GRU_MAX_H`` on CUDA, non-contiguous CUDA inputs, CUDA
    inputs that require a gradient under grad mode, or a launch error.
    Every launch adds one to ``bigru_fwd.launches`` and to its route's
    entry of ``bigru_fwd.routes``, also from inside an exported graph."""
    args = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    if torch.compiler.is_exporting():
        return torch.ops.percival.bigru_fwd(*args)
    if any(t.is_cuda for t in args):
        return _bigru_fwd_cuda(*args)
    return bigru_fwd_reference(*args)


bigru_fwd.launches = 0
bigru_fwd.routes = {"mma": 0, "simt": 0, "wide": 0, "wide_mma": 0, "wide_mma_stream": 0,
                    "wide_f32": 0, "narrow_f32": 0}


def bwd_launch(route: str, gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b,
               blocks: int = 0, rows: int = 0):
    """Launch the BPTT kernel of ``route`` (one of ``lstm_cuda.BWD_ROUTES``:
    ``"mma"``, ``"wide_mma"``, ``"wide_mma_stream"``, ``"wide_f32"``,
    ``"narrow_f32"``, ``"wide"`` or ``"simt"``; any other raises
    ``ValueError`` before anything is built or launched) on CUDA inputs that :func:`bigru_bwd` has checked; counts
    nothing. ``bigru_bwd``
    is the entry; ``chip_smoke.py`` times one route's kernel beside
    another's through this. ``"simt"`` runs H that is not a multiple of 32
    zero-padded to one (``lstm_cuda.at_width``), up to H = 320;
    ``"wide_mma"`` (bf16 only, H up to ``wide_mma_layout.max_h(3)``),
    ``"wide_mma_stream"`` (bf16 only, H up to
    ``wide_mma_layout.stream_bwd_max_h(3)``; past ``stream_max_h(3)`` on the
    deep layout) and ``"wide_f32"`` (f32 only, H up
    to ``wide_f32_layout.max_h(3)``) likewise;
    ``"narrow_f32"`` (f32 only, H up to 320) H that is not a multiple of 8,
    over at most ``blocks`` blocks a cluster and ``rows`` rows when given
    (``lstm_cuda.bwd_launch``'s overrides), and ``"wide_f32"`` ``rows`` rows
    (``lstm_cuda.wide_f32_plan``); ``"wide"`` raises ``ValueError`` past
    ``wide_layout.GRU_MAX_H``."""
    check_route(route, BWD_ROUTES, "bigru_bwd")
    from percivaltts_tpu_torch import _build

    device = gx_f.device
    T, B, G = gx_f.shape
    H = G // 3
    ins = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b)
    granule = {"simt": SIMT_BWD_GRANULE, "wide_mma": wide_mma_layout.K_GRANULE,
               "wide_mma_stream": wide_mma_layout.K_GRANULE,
               "wide_f32": wide_f32_layout.K_GRANULE,
               "narrow_f32": narrow_f32_layout.K_GRANULE}.get(route)
    if route == "wide_mma":
        _wide_mma_check(gx_f.dtype, H, 3)
    if route == "wide_mma_stream":
        _wide_mma_stream_check(gx_f.dtype, H, 3)
    if route == "wide_f32":
        _wide_f32_check(gx_f.dtype, H, 3)
    if route == "narrow_f32":
        _narrow_f32_check(gx_f.dtype, H, 3)
    if granule and H % granule and (route != "simt" or H <= SIMT_BWD_MAX_H):
        Hp = -(-H // granule) * granule
        return at_width(lambda *a: bwd_launch(route, *a, blocks=blocks, rows=rows), Hp, 3, *ins)
    lib = _build.library()
    dgx_f, dgx_b = torch.empty_like(gx_f), torch.empty_like(gx_b)
    dnr_f, dnr_b = torch.empty_like(hp_f), torch.empty_like(hp_b)
    outs = (dgx_f, dgx_b, dnr_f, dnr_b)
    with torch.cuda.device(device):
        if route == "mma":
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), aligned16(wh_f), aligned16(wh_b),
                   pack_wh(wh_f, "gru"), pack_wh(wh_b, "gru"), bn_f, bn_b,
                   *map(aligned16, (hp_f, hp_b, dy_f, dy_b)))
            err = lib.percival_bigru_bwd_mma(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs), T, B, H, stream,
            )
        elif route == "wide_mma":
            p = wide_mma_layout.plan(H, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), wide_mma_layout.pack_wh(wh_f, p),
                   wide_mma_layout.pack_wh(wh_b, p),
                   *map(aligned16, (bn_f, bn_b, hp_f, hp_b, dy_f, dy_b)))
            err = lib.percival_bigru_bwd_wide_mma(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide_mma_stream":
            sp = stream_plan("bigru", B, H, device.index)
            packed, p = stream_args(wh_f, wh_b, 3, sp.chunk)
            scratch = stream_scratch(sp, B, device)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (aligned16(gx_f), aligned16(gx_b), *packed,
                   *map(aligned16, (bn_f, bn_b, hp_f, hp_b, dy_f, dy_b)))
            err = lib.percival_bigru_bwd_wide_mma_stream(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                None if scratch is None else scratch.data_ptr(), T, B, H, p.Hb, p.U, stream,
            )
        elif route == "wide_f32":
            p = wide_layout.plan(H, 3)
            R = wide_f32_plan("bigru", B, H, rows, device.index).R
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (gx_f, gx_b, wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p),
                   bn_f, bn_b, aligned16(hp_f), aligned16(hp_b), dy_f, dy_b)
            err = lib.percival_bigru_bwd_wide_f32(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                T, B, H, p.Hb, p.U, R, stream,
            )
        elif route == "narrow_f32":
            p = narrow_f32_plan("bigru", B, H, blocks, rows, device.index)
            s = narrow_f32_layout.Split(*p[:4])
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            ins = (gx_f, gx_b, narrow_f32_layout.pack_wh(wh_f, s),
                   narrow_f32_layout.pack_wh(wh_b, s), bn_f, bn_b, aligned16(hp_f),
                   aligned16(hp_b), dy_f, dy_b)
            err = lib.percival_bigru_bwd_narrow_f32(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                T, B, H, p.Hb, p.U, p.R, stream,
            )
        elif route == "wide":
            p = wide_layout.plan(H, 3)
            stream = torch.cuda.current_stream(device).cuda_stream
            # held in names until the launch (see lstm_cuda.fwd_launch)
            packed = (wide_layout.pack_wh(wh_f, p), wide_layout.pack_wh(wh_b, p))
            err = lib.percival_bigru_bwd_wide(
                gx_f.data_ptr(), gx_b.data_ptr(), *(t.data_ptr() for t in packed),
                *(t.data_ptr() for t in (bn_f, bn_b, hp_f, hp_b, dy_f, dy_b)),
                *(t.data_ptr() for t in outs), T, B, H, p.Hb, p.U, _DTYPE_CODES[gx_f.dtype],
                stream,
            )
        else:
            rows, stream = _launch_geometry(device, B, H, "BiGRU BPTT", SIMT_BWD_MAX_H)
            err = lib.percival_bigru_bwd(
                *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in outs), T, B, H, _DTYPE_CODES[gx_f.dtype], rows, stream,
            )
    _build.check(err, f"bigru_bwd launch ({route})")
    return outs


def bigru_bwd(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b):
    """BPTT for both directions in one launch → ``(dgx_f, dgx_b, dnr_f,
    dnr_b)``.

    Arguments as :func:`bigru_bwd_reference`. CUDA tensors launch a
    hand-written kernel: the tensor-core one for bf16 with H a multiple of
    16 up to 128, the tensor-core cluster one for bf16 past 128 up to 672,
    the streamed tensor-core cluster one for bf16 past 672 up to 4096 (on
    its deep layout past 1792), the
    f32 cluster one for f32 past 320 up to 512 (its few-row kernels at
    B <= 8), the CUDA-core cluster one for f32 past 512,
    the f32 narrow cluster one for f32 up
    to 320, else the one-block CUDA-core one,
    H not a multiple of 32 zero-padded to one
    (:func:`~percivaltts_tpu_torch.ops.mma_layout.bwd_route`); CPU tensors
    run the twin. Raises on mixed devices, dtypes or shapes, non-contiguous
    CUDA inputs, CUDA inputs that require a gradient under grad mode, H past
    ``wide_layout.GRU_MAX_H``, or a launch error.
    Every launch adds one to ``bigru_bwd.launches`` and to its route's entry
    of ``bigru_bwd.routes``; a ``"wide_f32"`` launch also to its kernel's
    entry of ``bigru_bwd.wide_f32_plans``, a ``"wide_mma_stream"`` one to
    its layout's entry of ``bigru_bwd.stream_layouts`` (``"64k"`` or
    ``"deep"``)."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    _check_states(gx_f, hp_f, hp_b, dy_f, dy_b)
    ins = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b)
    device = _one_device("bigru_bwd", ins, "ops.gru_cuda.bigru_core")
    if device.type == "cpu":
        return bigru_bwd_reference(*ins)
    route = bwd_route(gx_f.dtype, gx_f.shape[-1] // 3, "gru", gx_f.shape[1])
    out = bwd_launch(route, *ins)
    bigru_bwd.launches += 1
    bigru_bwd.routes[route] += 1
    if route == "wide_f32":
        count_wide_f32(bigru_bwd, "bigru", gx_f.shape[1], gx_f.shape[-1] // 3, device.index)
    if route == "wide_mma_stream":
        count_stream(bigru_bwd, "bigru", gx_f.shape[1], gx_f.shape[-1] // 3, device.index)
    return out


bigru_bwd.launches = 0
bigru_bwd.routes = {"mma": 0, "simt": 0, "wide": 0, "wide_mma": 0, "wide_mma_stream": 0,
                    "wide_f32": 0, "narrow_f32": 0}
# the "wide_f32" launches by the kernel their plan took (lstm_cuda.count_wide_f32)
bigru_bwd.wide_f32_plans = {"chunked": 0, "few": 0}
# the "wide_mma_stream" launches by the layout their plan took (lstm_cuda.count_stream)
bigru_bwd.stream_layouts = {"64k": 0, "deep": 0}


class BiGRUFunction(torch.autograd.Function):
    """The forward kernel with the BPTT kernel as its backward (the
    ``bigru_core`` custom VJP, ``lstm_pallas.py:654-688``). ``fwd`` / ``bwd``
    are the kernel wrappers or their plain twins. First order only, as
    :class:`~percivaltts_tpu_torch.ops.lstm_cuda.BiLSTMFunction`."""

    @staticmethod
    def forward(ctx, gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, fwd, bwd):
        yf, yb = fwd(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
        ctx.save_for_backward(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, yf, yb)
        ctx.bwd = bwd
        return yf, yb

    @staticmethod
    @once_differentiable
    def backward(ctx, dyf, dyb):
        gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, yf, yb = ctx.saved_tensors
        # an output that fed nothing has no gradient; the slices of the
        # (T, B, 2H) concatenation arrive non-contiguous
        dyf = torch.zeros_like(yf) if dyf is None else dyf.contiguous()
        dyb = torch.zeros_like(yb) if dyb is None else dyb.contiguous()
        # previous state per direction from the saved (compute-dtype)
        # outputs: t-1 for fwd, t+1 for bwd
        z = torch.zeros_like(yf[:1])
        hp_f = torch.cat([z, yf[:-1]])
        hp_b = torch.cat([yb[1:], z])
        dgx_f, dgx_b, dnr_f, dnr_b = ctx.bwd(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b,
                                             hp_f, hp_b, dyf, dyb)
        H = wh_f.shape[0]

        def dwh(hp, dgx, dnr):
            # Σ_t h_prevᵀ·[dr_pre, dz_pre, dnr]: the recurrent n branch's
            # weight gradient reads dnr, not dn_pre. One GEMM outside the kernel
            d = torch.cat([dgx[..., : 2 * H], dnr], dim=-1)
            return hp.reshape(-1, H).T @ d.reshape(-1, 3 * H)

        def dbn(dnr):
            return dnr.float().sum(dim=(0, 1))

        return (dgx_f, dgx_b,
                dwh(hp_f, dgx_f, dnr_f).to(wh_f.dtype), dwh(hp_b, dgx_b, dnr_b).to(wh_b.dtype),
                dbn(dnr_f).to(bn_f.dtype), dbn(dnr_b).to(bn_b.dtype), None, None)


def bigru_core(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, fwd=bigru_fwd, bwd=bigru_bwd):
    """The recurrence, differentiable: through :class:`BiGRUFunction` when
    grad mode is on and an input requires a gradient, else ``fwd`` alone."""
    args = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return BiGRUFunction.apply(*args, fwd, bwd)
    return fwd(*args)


def bigru_core_reference(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b):
    """:func:`bigru_core` on the plain twins of both kernels."""
    return bigru_core(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, bigru_fwd_reference, bigru_bwd_reference)


def bigru(x, wi_f, wh_f, b_f, bn_f, wi_b, wh_b, b_b, bn_b, core=bigru_core):
    """``(B, T, D)`` → ``(B, T, 2H)`` fused bidirectional GRU
    (``bigru_pallas``). ``b`` is the input-projection bias (r, z, n
    concatenated), ``bn`` the recurrent n-branch bias. The input projections
    ``x @ W_i + b`` are plain GEMMs outside the recurrence, as in the JAX
    package (``lstm_cuda.input_gates``); ``core`` runs the recurrence (tests
    and the smoke run substitute the plain twins)."""
    xt = x.transpose(0, 1).contiguous()  # (T, B, D)
    gx_f, gx_b = input_gates(xt, wi_f, b_f), input_gates(xt, wi_b, b_b)  # (T, B, 3H)
    yf, yb = core(gx_f, gx_b, wh_f.contiguous(), wh_b.contiguous(),
                  bn_f.contiguous(), bn_b.contiguous())
    return torch.cat([yf, yb], dim=-1).transpose(0, 1)
