"""On-device input normalization (counterpart of
``percivaltts_tpu/training/ondevice.py``): raw batches go to the device and
``(x − shift)·scale`` runs there, inside the step; padded frames are
re-zeroed afterwards so a nonzero shift never leaks into the losses."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from percivaltts_tpu_torch.data.normalize import NormStats


def _affine(stats: NormStats, device) -> tuple:
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return as_t(stats.shift), as_t(stats.scale)


def _normalize_batch(batch: Dict[str, torch.Tensor], in_aff, out_aff) -> Dict[str, torch.Tensor]:
    """``lab`` and ``cmp`` normalized and re-masked; other keys as they are.
    Broadcasts over any leading axes (the stacked critic batches)."""
    (si, ci), (so, co) = in_aff, out_aff
    m = batch["mask"][..., None]
    out = dict(batch)
    out["lab"] = (batch["lab"] - si) * ci * m
    out["cmp"] = (batch["cmp"] - so) * co * m
    return out


def make_normalizing_step(
    step_fn: Callable, in_stats: NormStats, out_stats: NormStats, device
) -> Callable:
    """Wrap a train step ``(state, *batches, **kw) → (state, metrics)`` so
    every batch dict argument (tensors on ``device``) is normalized on the
    device first. Works for the LSE step (one batch) and the WGAN step
    (stacked critic batches + generator batch)."""
    in_aff = _affine(in_stats, device)
    out_aff = _affine(out_stats, device)

    def wrapped(state, *batches, **kwargs):
        normed = tuple(_normalize_batch(b, in_aff, out_aff) for b in batches)
        return step_fn(state, *normed, **kwargs)

    return wrapped
