"""Model-level utilities (counterpart of ``percivaltts_tpu/models/base.py``):
dtype lookup, flax-rule parameter init, flax's LayerNorm, parameter count,
and utterance prediction with the reference's padding and grouping."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn


def dtype_by_name(name: str) -> torch.dtype:
    """Shared compute/param dtype lookup for the model zoo."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# Utterances are padded up to a multiple of this for prediction, exactly as
# the JAX package pads them: the BiLSTM is unmasked and its backward
# direction reads the zero tail, so the padded length is part of the result.
TIME_MULTIPLE = 64

# flax lecun_normal: variance_scaling(1, "fan_in", "truncated_normal") draws
# from N(0, 1) truncated to [-2, 2] and rescales by this factor (the std of
# that truncated normal) so the result has variance exactly 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """In place: flax's default Dense/Conv kernel init (truncated normal,
    variance 1/fan_in), drawn from ``generator``."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's nn.LayerNorm defaults to 1e-5)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=x.dtype)`` over the last axis: statistics in
    f32 with the fast variance E[x²] − E[x]² clipped at 0, the f32 scale and
    bias applied, the result cast back to ``x``'s (compute) dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((x32 - mean) * mul + bias.float()).to(x.dtype)


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` split along one axis of ``n`` samples for a
    stride-``stride`` conv of ``k`` taps: (lo, hi) with the extra tap on the
    right, so lo = (k − 1) // 2 at stride 1."""
    n_out = -(-n // stride)
    total = max((n_out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _run(model: nn.Module, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        y = model(torch.from_numpy(x).to(_device(model)))
        return y.float().cpu().numpy()


def predict_utterance(
    model: nn.Module, lab: np.ndarray, time_multiple: int = TIME_MULTIPLE
) -> np.ndarray:
    """Run one normalized utterance ``(frames, label_dim)`` through a
    generator, zero-padded up to the next multiple of ``time_multiple`` and
    cropped back."""
    n = lab.shape[0]
    padded = -(-n // time_multiple) * time_multiple
    x = np.zeros((1, padded, lab.shape[1]), dtype=np.float32)
    x[0, :n] = lab
    return _run(model, x)[0, :n]


def predict_batch(
    model: nn.Module, labs, time_multiple: int = TIME_MULTIPLE, chunk: int = 8
) -> list:
    """Predict normalized utterances in stacked chunks of ``chunk`` rows.

    As in the JAX package: utterances are grouped by their OWN padded length
    (next multiple of ``time_multiple``) and chunks stay within a group, so
    each utterance sees exactly the padding ``predict_utterance`` gives it
    and never depends on its neighbours; a short chunk repeats its last row
    so every call of one padded length has the same shape."""
    labs = list(labs)
    out: list = [None] * len(labs)
    groups: dict = {}
    for i, lab in enumerate(labs):
        padded = -(-lab.shape[0] // time_multiple) * time_multiple
        groups.setdefault(padded, []).append(i)
    for padded, idxs in groups.items():
        for c0 in range(0, len(idxs), chunk):
            sel = idxs[c0 : c0 + chunk]
            rows = sel + [sel[-1]] * (chunk - len(sel))
            x = np.zeros((chunk, padded, labs[sel[0]].shape[1]), np.float32)
            for j, i in enumerate(rows):
                x[j, : labs[i].shape[0]] = labs[i]
            y = _run(model, x)
            for j, i in enumerate(sel):
                out[i] = y[j, : labs[i].shape[0]]
    return out
