"""Masked sequence losses (counterpart of
``percivaltts_tpu/training/losses.py``). Masks are mandatory: every loss is
mask-weighted so padding never reaches a gradient.

Under a data-parallel mesh each rank holds its own rows of the batch, and
the batch-wide denominators (the frame count, the mean flux) are summed
over the ranks, so each rank's loss is its share of the global loss: the
shares sum to what world size 1 computes, and so do their gradients."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from percivaltts_tpu_torch.parallel.mesh import Mesh, global_sum


def masked_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    dim_weights: Optional[torch.Tensor] = None,
    frame_weights: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Mean squared error over valid frames, in float32. mask (B, T);
    pred/target (B, T, D); ``dim_weights`` (D,) weights feature dimensions,
    ``frame_weights`` (B, T) weights frames. ``mesh``: this rank's share,
    over the frames of every rank (one all-reduce of the mask sum)."""
    se = ((pred - target).float() * mask[..., None]).square()
    if dim_weights is not None:
        se = se * dim_weights
    if frame_weights is not None:
        se = se * frame_weights[..., None]
    denom = global_sum(mask.sum(), mesh).clamp_min(1.0) * pred.shape[-1]
    return se.sum() / denom


def masked_rmse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(masked_mse(pred, target, mask))


def transition_weights(
    target: torch.Tensor, mask: torch.Tensor, gain: float, radius: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Per-frame loss weights (B, T) that upweight target transitions: the
    target's local flux ‖x_t − x_{t−1}‖² (both frames valid), max-pooled
    over ±radius with identity 0, normalized to mean 1 over valid frames;
    ``w = (1 + gain·flux_norm) / (1 + gain)``, 0 on padding. ``mesh``: the
    mean over the valid frames of every rank (one all-reduce)."""
    x = target.float()
    m2 = mask * F.pad(mask[:, :-1], (1, 0))  # both frames valid
    flux = (x[:, 1:] - x[:, :-1]).square().sum(-1)
    flux = F.pad(flux, (1, 0)) * m2
    if radius > 0:
        padded = F.pad(flux, (radius, radius), value=0.0)  # flux >= 0: 0 is the identity
        flux = F.max_pool1d(padded[:, None], 2 * radius + 1, stride=1)[:, 0] * mask
    flux_sum, frames = global_sum(torch.stack([flux.sum(), mask.sum()]), mesh)
    mean = flux_sum / frames.clamp_min(1.0)
    w = (1.0 + gain * flux / mean.clamp_min(1e-12)) / (1.0 + gain)
    return torch.where(mask > 0, w, torch.zeros_like(w))


def stream_weight_vector(streams, stream_weights, feat_dim: int) -> Optional[torch.Tensor]:
    """{stream name → weight} → a (feat_dim,) per-dimension weight vector
    from the vocoder's stream slices; None when empty. The steps move it to
    their batches' device."""
    if not stream_weights:
        return None
    w = np.ones((feat_dim,), np.float32)
    for name, weight in dict(stream_weights).items():
        a, b = streams[name]
        w[a:b] = weight
    return torch.from_numpy(w)
