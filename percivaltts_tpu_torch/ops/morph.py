"""1-D morphology over the frame axis, edge-replicated, batched.

Counterpart of ``percivaltts_tpu/ops/morph.py``: the same dilations,
erosions and nearest-interior fill along axis 1 of ``(B, nf)`` or
``(B, nf, k)`` tensors (the JAX module works on axis 0 of one utterance).
The vocoder's synthesis and closed-loop gates need "within r frames of a
marker" (dilate) and "at least r frames inside a region" (erode) masks.
"""

from __future__ import annotations

import torch


def shift_frames(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` moved by ``k`` frames along axis 1, edge-replicated:
    ``out[:, i] = x[:, clamp(i + k, 0, nf − 1)]``."""
    nf = x.shape[1]
    idx = torch.clamp(torch.arange(nf, device=x.device) + k, 0, nf - 1)
    return x.index_select(1, idx)


def dilate1d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Running max over ±``radius`` frames along axis 1, edge-replicated.
    Float tensors (bools: convert first). radius 0 returns ``x``."""
    out = x
    for k in range(1, radius + 1):
        out = torch.maximum(out, torch.maximum(shift_frames(x, k), shift_frames(x, -k)))
    return out


def erode1d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Running min over ±``radius`` frames along axis 1, edge-replicated."""
    out = x
    for k in range(1, radius + 1):
        out = torch.minimum(out, torch.minimum(shift_frames(x, k), shift_frames(x, -k)))
    return out


def fill_from_interior(x: torch.Tensor, interior: torch.Tensor, iters: int):
    """Nearest-interior fill along axis 1: propagate ``x``'s values outward
    from ``interior`` (bool mask, same leading shape as ``x``) one frame per
    iteration, earlier frame winning ties. Returns ``(filled, reached)``
    where ``reached`` marks frames within ``iters`` of an interior frame;
    frames beyond keep their original values."""
    filled, cm = x, interior
    for _ in range(iters):
        pv, nv = shift_frames(cm, -1), shift_frames(cm, 1)
        prev, nxt = shift_frames(filled, -1), shift_frames(filled, 1)
        filled = torch.where(cm, filled, torch.where(pv, prev, torch.where(nv, nxt, filled)))
        cm = cm | pv | nv
    return filled, cm
