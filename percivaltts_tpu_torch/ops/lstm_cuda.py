"""Fused bidirectional LSTM forward: the CUDA kernel and its plain twin.

Counterpart of the forward half of ``percivaltts_tpu/ops/lstm_pallas.py``
(``_fwd_kernel`` / ``_bilstm_fwd_pallas``, ``bilstm_core``, ``bilstm_pallas``).
Same time-major ``(T, B, 4H)`` gate layout, gate order i, f, g, o, f32
carries, and ``h`` rounded to the compute dtype before the recurrent product.

``bilstm_fwd`` dispatches on where its tensors lie: CUDA tensors launch
``csrc/bilstm_fwd.cu`` (or raise), CPU tensors take ``bilstm_fwd_reference``.
There is no other fallback. The kernel has no backward yet (the BPTT kernel
is a later slice), so the CUDA path refuses inputs that require a gradient.
"""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = (1, 2, 4, 8)  # batch rows per block the kernel is instantiated for


def _gates(z: torch.Tensor, H: int):
    i, f, g, o = z.split(H, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells: bool = False):
    """Plain PyTorch twin of the kernel: ``(T, B, 4H)`` input gates per
    direction and ``(H, 4H)`` recurrent kernels → ``(y_f, y_b)`` (and
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
        raise TypeError(f"bilstm_fwd takes one dtype of float32/bfloat16, got {dts}")


def rows_per_block(B: int, n_sm: int) -> int:
    """Batch rows per block: the smallest tile whose grid (2 directions ×
    ceil(B / rows) blocks) still fits one wave of the card's SMs — a smaller
    tile means a shorter sequential step — else the largest tile."""
    for r in _ROWS:
        if 2 * -(-B // r) <= n_sm:
            return r
    return _ROWS[-1]


def bilstm_fwd(gx_f, gx_b, wh_f, wh_b, with_cells: bool = False):
    """Both LSTM directions over precomputed input gates, in one launch.

    CUDA tensors launch the hand-written kernel; CPU tensors run
    :func:`bilstm_fwd_reference`. Raises on mixed devices, another dtype
    than float32/bfloat16, a shape mismatch, non-contiguous CUDA inputs,
    CUDA inputs that require a gradient, or a launch error. Every launch
    adds one to ``bilstm_fwd.launches``."""
    _check_shapes(gx_f, gx_b, wh_f, wh_b)
    devices = {t.device for t in (gx_f, gx_b, wh_f, wh_b)}
    if len(devices) != 1:
        raise ValueError(f"bilstm_fwd inputs lie on several devices: {devices}")
    device = gx_f.device
    if device.type == "cpu":
        return bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells)
    if device.type != "cuda":
        raise ValueError(f"bilstm_fwd runs on cuda or cpu tensors, got {device}")
    if not all(t.is_contiguous() for t in (gx_f, gx_b, wh_f, wh_b)):
        raise ValueError("bilstm_fwd needs contiguous CUDA inputs")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (gx_f, gx_b, wh_f, wh_b)
    ):
        raise NotImplementedError(
            "the CUDA BiLSTM has no backward kernel yet (ROADMAP: TPU kernels "
            "still to port, #2 _bwd_kernel); run it under torch.no_grad()"
        )

    from percivaltts_tpu_torch import _build

    lib = _build.library()
    T, B, G = gx_f.shape
    H = G // 4
    if G > 1024:  # one thread per gate column
        raise ValueError(f"the CUDA BiLSTM takes H <= 256, got H={H}")
    new = lambda: torch.empty((T, B, H), dtype=gx_f.dtype, device=device)  # noqa: E731
    yf, yb = new(), new()
    cf, cb = (new(), new()) if with_cells else (None, None)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        err = lib.percival_bilstm_fwd(
            gx_f.data_ptr(), gx_b.data_ptr(), wh_f.data_ptr(), wh_b.data_ptr(),
            yf.data_ptr(), yb.data_ptr(),
            cf.data_ptr() if with_cells else None,
            cb.data_ptr() if with_cells else None,
            T, B, H, _DTYPE_CODES[gx_f.dtype], rows_per_block(B, n_sm),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "bilstm_fwd launch")
    bilstm_fwd.launches += 1
    return (yf, yb, cf, cb) if with_cells else (yf, yb)


bilstm_fwd.launches = 0


def bilstm(x, wi_f, wh_f, b_f, wi_b, wh_b, b_b, core=bilstm_fwd):
    """``(B, T, D)`` → ``(B, T, 2H)`` fused bidirectional LSTM
    (``bilstm_pallas``). The input projections ``x @ W_i + b`` are plain
    GEMMs outside the recurrence, as in the JAX package; ``core`` runs the
    recurrence (the kernel wrapper; tests substitute the plain twin)."""
    gx_f = (x @ wi_f + b_f).transpose(0, 1).contiguous()  # (T, B, 4H)
    gx_b = (x @ wi_b + b_b).transpose(0, 1).contiguous()
    yf, yb = core(gx_f, gx_b, wh_f.contiguous(), wh_b.contiguous())
    return torch.cat([yf, yb], dim=-1).transpose(0, 1)
