"""Conditional Wasserstein critic (counterpart of
``percivaltts_tpu/models/critic.py``, ``Critic`` and ``build_critic``).

score = Critic(features, conditioning labels, mask), one float32 per
sequence: a strided conv stack over the spectral stream, a dense path for
the other streams and one for the labels (both time-pooled to the conv
stack's rate before their Dense layers), merged, scored per downsampled
frame and mean-pooled over the downsampled mask. No batch norm (the
gradient penalty is per sample); ``norm`` is ``"none"`` or ``"layer"``.
The conv stack is either time-1D at ``hidden`` channels over a Dense
projection of the stream (``conv_style="time1d"``), or, reference-faithful
(``"2d"``), 2-D convs over the masked (T, freq) image with
``channels · min(2^(i//2 + 1), 8)`` channels in block i, then a mean over
frequency.

Parity notes, each pinned by a test:
* layer names are the flax ones (``spec_in``, ``spec_conv{i}``,
  ``spec_ln{i}``, ``rest_d0``, ``cond_d0``, ``merge_d0``, ``score``, …) so
  ``weights.py`` maps the trees by path;
* flax ``SAME`` padding at stride 2 puts the extra tap on the right:
  lo = total // 2 with total = (T' − 1)·s + k − T, so (1, 2) for k=5 at even
  T, where ``Conv1d(padding=2)`` would pad (2, 2); the 2d style splits each
  axis so (the 65 frequency bands pad (2, 2) at k=5);
* flax LayerNorm (``models/base.py::layer_norm``) over the channel axis
  only, which in the 2d style's (B, C, T, freq) layout is dim 1;
* flax ``gelu`` is the tanh form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from percivaltts_tpu_torch.config import ModelConfig, VocoderConfig
from percivaltts_tpu_torch.models.base import LN_EPS, dtype_by_name, layer_norm, same_padding
from percivaltts_tpu_torch.models.generators import (
    _new_conv1d,
    _new_conv2d,
    _new_dense,
    conv2d_same,
    gelu,
)


class Critic(nn.Module):
    """score = Critic(cmp, lab, mask) ∈ R per sample."""

    def __init__(
        self,
        vocoder: VocoderConfig,
        label_dim: int,
        channels: int = 32,
        blocks: int = 4,
        hidden: int = 256,
        kernel: Tuple[int, int] = (5, 5),
        conv_style: str = "time1d",
        norm: str = "layer",
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if conv_style not in ("time1d", "2d"):
            raise ValueError(f"unknown conv_style: {conv_style}")
        if norm not in ("layer", "none"):
            raise ValueError(f"unknown critic norm: {norm}")
        g = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.streams = dict(vocoder.streams)
        self.spec_key = "spec" if "spec" in self.streams else "mel"
        self.blocks = blocks
        self.conv_style = conv_style
        self.kernel_time = kernel[0]
        self.norm = norm
        self.total_stride = 2 ** ((blocks + 1) // 2)  # stride 2 every other block

        a, b = self.streams[self.spec_key]
        if conv_style == "2d":
            self.spec_in = _new_conv2d(1, channels, kernel, pdt, g)
            width = channels
            for i in range(blocks):
                out = channels * min(2 ** (i // 2 + 1), 8)
                self.add_module(f"spec_conv{i}", _new_conv2d(width, out, kernel, pdt, g))
                width = out
                if norm == "layer":
                    self.add_module(f"spec_ln{i}", nn.LayerNorm(width, eps=LN_EPS, dtype=pdt))
        else:
            self.spec_in = _new_dense(b - a, hidden, pdt, g)
            width = hidden
            for i in range(blocks):
                self.add_module(f"spec_conv{i}",
                                _new_conv1d(hidden, hidden, self.kernel_time, pdt, g))
                if norm == "layer":
                    self.add_module(f"spec_ln{i}", nn.LayerNorm(hidden, eps=LN_EPS, dtype=pdt))
        self.rest = [(s, e) for name, (s, e) in self.streams.items() if name != self.spec_key]
        merge_in = width + hidden // 2  # the conv stack's channels and the labels' path
        if self.rest:
            rest_dim = sum(e - s for s, e in self.rest)
            self.rest_d0 = _new_dense(rest_dim, hidden // 2, pdt, g)
            self.rest_d1 = _new_dense(hidden // 2, hidden // 2, pdt, g)
            merge_in += hidden // 2
        self.cond_d0 = _new_dense(label_dim, hidden // 2, pdt, g)
        self.merge_d0 = _new_dense(merge_in, hidden, pdt, g)
        self.merge_d1 = _new_dense(hidden, hidden, pdt, g)
        self.score = _new_dense(hidden, 1, pdt, g)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, name)
        dt = self.compute_dtype
        return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """flax LayerNorm ``spec_ln{i}`` over the last axis (channels) when
        ``norm="layer"``."""
        if self.norm != "layer":
            return x
        ln = getattr(self, f"spec_ln{i}")
        return layer_norm(x, ln.weight, ln.bias, ln.eps)

    def _spec_time1d(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, F) masked spectral stream → (B, T', hidden)."""
        dt = self.compute_dtype
        x = self._dense("spec_in", spec)  # (B, T, C)
        k = self.kernel_time
        for i in range(self.blocks):
            stride = 2 if i % 2 == 0 else 1
            conv = getattr(self, f"spec_conv{i}")
            h = gelu(x).transpose(1, 2)  # (B, C, T) for the time conv
            h = F.conv1d(F.pad(h, same_padding(h.shape[-1], k, stride)),
                         conv.weight.to(dt), conv.bias.to(dt), stride=stride)
            x = self._norm(i, h.transpose(1, 2))
        return x

    def _spec_2d(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, T, F) masked spectral stream → (B, T', C): the (B, 1, T, F)
        image through the 2-D convs (stride (2, 2) on even blocks), each
        normalized over its channels, then the mean over frequency."""
        dt = self.compute_dtype
        x = conv2d_same(self.spec_in, spec[:, None], dt)
        for i in range(self.blocks):
            stride = 2 if i % 2 == 0 else 1
            x = conv2d_same(getattr(self, f"spec_conv{i}"), gelu(x), dt, stride)
            if self.norm == "layer":
                x = self._norm(i, x.movedim(1, -1)).movedim(-1, 1)
        return x.mean(dim=3).transpose(1, 2)

    def forward(self, cmp: torch.Tensor, lab: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """cmp (B, T, feat_dim), lab (B, T, label_dim), mask (B, T) → (B,)
        float32 scores. T must be a multiple of the total time stride."""
        dt = self.compute_dtype
        cmp = cmp.to(dt)
        mask = mask.to(dt)
        B, T = mask.shape
        ts = self.total_stride
        if T % ts != 0:
            raise ValueError(
                f"critic needs sequence length divisible by its total time "
                f"stride {ts} (got {T}); pick bucket bounds that are "
                f"multiples of {ts}"
            )
        m3 = mask[:, :, None]
        a, b = self.streams[self.spec_key]
        spec = cmp[..., a:b] * m3
        x = self._spec_2d(spec) if self.conv_style == "2d" else self._spec_time1d(spec)

        Tp = x.shape[1]

        def pool_t(z):
            return z[:, : Tp * ts].reshape(B, Tp, ts, z.shape[-1]).mean(dim=2)

        parts = [x]
        if self.rest:
            r = torch.cat([cmp[..., s:e] for s, e in self.rest], dim=-1)
            r = self._dense("rest_d0", pool_t(r * m3))
            parts.append(self._dense("rest_d1", gelu(r)))
        parts.append(gelu(self._dense("cond_d0", pool_t(lab.to(dt) * m3))))

        h = gelu(self._dense("merge_d0", torch.cat(parts, dim=-1)))
        h = gelu(self._dense("merge_d1", h))
        score_t = self._dense("score", h)[..., 0]  # (B, T')

        m = mask[:, : Tp * ts].reshape(B, Tp, ts).amax(dim=2)
        denom = m.sum(dim=1).clamp_min(1.0)
        return ((score_t * m).sum(dim=1) / denom).float()


def build_critic(
    model_cfg: ModelConfig,
    vocoder: VocoderConfig,
    label_dim: int,
    generator: Optional[torch.Generator] = None,
) -> Critic:
    """Config → critic, its parameters drawn on the CPU from ``generator``
    (seed 0 when omitted) with flax's init rules. flax infers the label
    width at init; here it is an argument. ``critic_channels`` sizes only
    the 2d style."""
    return Critic(
        vocoder=vocoder,
        label_dim=label_dim,
        channels=model_cfg.critic_channels,
        blocks=model_cfg.critic_blocks,
        hidden=model_cfg.critic_hidden,
        kernel=(model_cfg.critic_kernel, model_cfg.critic_kernel),
        conv_style=model_cfg.conv_style,
        norm=model_cfg.critic_norm,
        compute_dtype=model_cfg.compute_dtype,
        param_dtype=model_cfg.param_dtype,
        generator=generator,
    )
