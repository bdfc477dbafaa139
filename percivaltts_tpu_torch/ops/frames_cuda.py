"""Centred framing × window and centred overlap-add: the CUDA kernels and
their plain twins.

Counterpart of ``percivaltts_tpu/ops/pallas_kernels.py`` (``frame_window``,
``overlap_add``), with a leading batch axis. In the JAX package these two
Pallas kernels are alternates that no path calls (the shifted-view XLA code of
``ops/stft.py`` is the default there); in the port they are the framing and
overlap-add of every ``ops/stft.py`` call on the card.

``frame_window`` and ``overlap_add`` dispatch on where their tensors lie:
CUDA tensors launch ``csrc/frame_window.cu`` / ``csrc/overlap_add.cu`` (or
raise), CPU tensors take ``frame_window_reference`` / ``overlap_add_reference``,
the shifted-view scheme of ``percivaltts_tpu/ops/stft.py:37-100``. There is no
other fallback. Both are also the registered operators
``percival::frame_window`` / ``percival::overlap_add`` (fake kernels beside
them), which the wrappers call while ``torch.export`` traces, so that an
exported graph launches the same kernels. Bounds on the card (both bytes, at 3.35 TB/s), and what each
kernel's design does about them, are in the kernels' sources;
``ops/frames_layout.py`` replays each kernel's partition on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def frame_window_reference(x, frame_length: int, hop: int, window=None):
    """Plain PyTorch twin of the framing kernel: ``(B, n)`` →
    ``(B, ceil(n / hop), frame_length)``, frame i centred on sample i·hop (zeros
    outside the signal), times ``window`` (``(frame_length,)``) when given.

    Frame starts are hop-aligned, so the frames are R = ceil(fl / hop) shifted
    views of the signal cut into hop-long blocks, as ``stft.py::frame_signal``
    builds them; the window multiply is the kernel's one rounding."""
    _check_frame_args(x, frame_length, hop, window)
    B, n = x.shape
    nf = _cdiv(n, hop)
    R = _cdiv(frame_length, hop)
    # the tail pad covers the (nf + R + 1) blocks read below for any fl/hop
    xp = F.pad(x, (frame_length // 2, frame_length + 3 * hop))
    blocks = xp[:, : (nf + R + 1) * hop].reshape(B, nf + R + 1, hop)
    frames = torch.stack([blocks[:, r : r + nf] for r in range(R)], dim=2)
    frames = frames.reshape(B, nf, R * hop)[..., :frame_length]
    return frames.contiguous() if window is None else frames * window


def overlap_add_reference(frames, hop: int, out_length: int):
    """Plain PyTorch twin of the overlap-add kernel: ``(B, nf, fl)`` →
    ``(B, out_length)``; frame i is added centred on sample i·hop. The R
    shifted adds run in the order r = 0 … R−1 into a buffer of the frames'
    dtype, as ``stft.py::overlap_add`` does, which the kernel repeats."""
    _check_ola_args(frames, hop, out_length)
    B, nf, fl = frames.shape
    R = _cdiv(fl, hop)
    fp = F.pad(frames, (0, R * hop - fl)).reshape(B, nf, R, hop)
    buf = frames.new_zeros((B, nf + R, hop))
    for r in range(R):
        buf[:, r : r + nf] += fp[:, :, r]
    half = fl // 2
    return buf.reshape(B, -1)[:, half : half + out_length]


def _check_frame_args(x, frame_length, hop, window) -> None:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"x must be (B, n) with B, n >= 1, got {tuple(x.shape)}")
    if frame_length < 1 or hop < 1:
        raise ValueError(f"frame_length and hop must be >= 1, got {frame_length}, {hop}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"framing takes float32 or bfloat16, got {x.dtype}")
    if window is not None:
        if tuple(window.shape) != (frame_length,):
            raise ValueError(f"window must be ({frame_length},), got {tuple(window.shape)}")
        if window.dtype != x.dtype:
            raise TypeError(f"window is {window.dtype}, the signal {x.dtype}")


def _check_ola_args(frames, hop, out_length) -> None:
    if frames.dim() != 3 or min(frames.shape) < 1:
        raise ValueError(f"frames must be (B, nf, fl) with each >= 1, got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPE_CODES:
        raise TypeError(f"overlap-add takes float32 or bfloat16, got {frames.dtype}")
    _, nf, fl = frames.shape
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    most = (nf + _cdiv(fl, hop)) * hop - fl // 2  # the samples the frames reach
    if not 1 <= out_length <= most:
        raise ValueError(f"out_length must lie in [1, {most}] for {nf} frames of {fl}, "
                         f"hop {hop}; got {out_length}")


def _cuda_device(name: str, tensors, contiguous: bool = True) -> torch.device:
    """The one device of ``tensors`` (cuda or cpu); raises on several
    devices, another device type, non-contiguous CUDA tensors (when
    ``contiguous``), or CUDA tensors that require a gradient under grad
    mode (the kernels have no backward)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    if contiguous and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous CUDA inputs")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} launches a kernel without a backward; call it on "
                           "tensors that do not require a gradient")
    return device


def _frame_window_cuda(x, frame_length: int, hop: int, window=None):
    """The CUDA kernel of ``percival::frame_window``: checks, one launch of
    ``csrc/frame_window.cu``, one count on ``frame_window.launches``."""
    _check_frame_args(x, frame_length, hop, window)
    device = _cuda_device("frame_window", (x,) if window is None else (x, window))

    from percivaltts_tpu_torch import _build

    lib = _build.library()
    B, n = x.shape
    out = torch.empty((B, _cdiv(n, hop), frame_length), dtype=x.dtype, device=device)
    with torch.cuda.device(device):
        err = lib.percival_frame_window(
            x.data_ptr(), None if window is None else window.data_ptr(), out.data_ptr(),
            B, n, frame_length, hop, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "frame_window launch")
    frame_window.launches += 1
    return out


def _overlap_add_cuda(frames, hop: int, out_length: int):
    """The CUDA kernel of ``percival::overlap_add``: checks, one launch of
    ``csrc/overlap_add.cu``, one count on ``overlap_add.launches``."""
    _check_ola_args(frames, hop, out_length)
    device = _cuda_device("overlap_add", (frames,), contiguous=False)
    if frames.stride(-1) != 1 and frames.shape[-1] > 1:
        raise ValueError("overlap_add needs CUDA frames whose last axis is contiguous, "
                         f"got strides {frames.stride()}")

    from percivaltts_tpu_torch import _build

    lib = _build.library()
    B, nf, fl = frames.shape
    out = torch.empty((B, out_length), dtype=frames.dtype, device=device)
    with torch.cuda.device(device):
        err = lib.percival_overlap_add(
            frames.data_ptr(), out.data_ptr(), B, nf, fl, hop, out_length,
            frames.stride(0), frames.stride(1), _DTYPE_CODES[frames.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "overlap_add launch")
    overlap_add.launches += 1
    return out


# The two kernels as registered operators, which a graph that ``torch.export``
# traces holds (their fake kernels check the arguments and give the output's
# shape and dtype); the graph's calls launch the same CUDA functions as eager
# code, counts included. Eager calls skip the dispatcher, whose few µs a call
# (on Griffin-Lim's 388 launches a vocode) showed on the card. CPU tensors
# take the twins, which check their arguments; the CPU overlap-add is copied
# out of its buffer, as the kernel's output is fresh and contiguous. Mixed
# devices reach the CUDA function, which refuses them.
torch.library.define("percival::frame_window",
                     "(Tensor x, int frame_length, int hop, Tensor? window) -> Tensor")
torch.library.impl("percival::frame_window", "CUDA", _frame_window_cuda)
torch.library.impl("percival::frame_window", "CPU", frame_window_reference)
torch.library.define("percival::overlap_add",
                     "(Tensor frames, int hop, int out_length) -> Tensor")
torch.library.impl("percival::overlap_add", "CUDA", _overlap_add_cuda)
torch.library.impl("percival::overlap_add", "CPU",
                   lambda frames, hop, out_length:
                   overlap_add_reference(frames, hop, out_length).clone(
                       memory_format=torch.contiguous_format))


@torch.library.register_fake("percival::frame_window")
def _frame_window_fake(x, frame_length, hop, window=None):
    _check_frame_args(x, frame_length, hop, window)
    B, n = x.shape
    return x.new_empty((B, _cdiv(n, hop), frame_length))


@torch.library.register_fake("percival::overlap_add")
def _overlap_add_fake(frames, hop, out_length):
    _check_ola_args(frames, hop, out_length)
    return frames.new_empty((frames.shape[0], out_length))


def frame_window(x, frame_length: int, hop: int, window=None):
    """Centred framing × window, ``(B, n)`` → ``(B, ceil(n / hop), frame_length)``;
    the operator ``percival::frame_window`` while ``torch.export`` traces.

    CUDA tensors launch the hand-written kernel; CPU tensors run
    :func:`frame_window_reference`. Raises on mixed devices, another dtype
    than float32/bfloat16 (the window's must be the signal's), a shape
    mismatch, non-contiguous CUDA inputs, CUDA inputs that require a gradient
    under grad mode, or a launch error. Every launch adds one to
    ``frame_window.launches``, also from inside an exported graph."""
    if torch.compiler.is_exporting():
        return torch.ops.percival.frame_window(x, frame_length, hop, window)
    if x.is_cuda or (window is not None and window.is_cuda):
        return _frame_window_cuda(x, frame_length, hop, window)
    return frame_window_reference(x, frame_length, hop, window)


frame_window.launches = 0


def overlap_add(frames, hop: int, out_length: int):
    """Centred overlap-add, ``(B, nf, fl)`` → ``(B, out_length)``; the operator
    ``percival::overlap_add`` while ``torch.export`` traces.

    CUDA tensors launch the hand-written kernel, which reads the frames
    through their batch and frame strides (0 included: a broadcast row is
    read without a copy); CPU tensors run :func:`overlap_add_reference`.
    Raises on another dtype than float32/bfloat16, an ``out_length`` past
    the samples the frames reach, CUDA frames whose last axis is not
    contiguous, frames that require a gradient under grad mode, or a launch
    error. Every launch adds one to ``overlap_add.launches``, also from
    inside an exported graph."""
    if torch.compiler.is_exporting():
        return torch.ops.percival.overlap_add(frames, hop, out_length)
    if frames.is_cuda:
        return _overlap_add_cuda(frames, hop, out_length)
    return overlap_add_reference(frames, hop, out_length)


overlap_add.launches = 0
