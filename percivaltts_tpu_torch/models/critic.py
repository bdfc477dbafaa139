"""Conditional Wasserstein critic (counterpart of
``percivaltts_tpu/models/critic.py``, ``Critic`` and ``build_critic``).

score = Critic(features, conditioning labels, mask), one float32 per
sequence: a time-1D strided conv stack over the spectral stream, a dense
path for the other streams and one for the labels (both time-pooled to the
conv stack's rate before their Dense layers), merged, scored per downsampled
frame and mean-pooled over the downsampled mask. No batch norm (the
gradient penalty is per sample); ``norm`` is ``"none"`` or ``"layer"``.

Parity notes, each pinned by a test:
* layer names are the flax ones (``spec_in``, ``spec_conv{i}``,
  ``spec_ln{i}``, ``rest_d0``, ``cond_d0``, ``merge_d0``, ``score``, …) so
  ``weights.py`` maps the trees by path;
* flax ``SAME`` padding at stride 2 puts the extra tap on the right:
  lo = total // 2 with total = (T' − 1)·s + k − T, so (1, 2) for k=5 at even
  T, where ``Conv1d(padding=2)`` would pad (2, 2);
* flax LayerNorm: statistics in f32 with the fast variance
  E[x²] − E[x]² clipped at 0, eps 1e-6, then cast to the compute dtype;
* flax ``gelu`` is the tanh form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from percivaltts_tpu_torch.config import ModelConfig, VocoderConfig
from percivaltts_tpu_torch.models.base import dtype_by_name
from percivaltts_tpu_torch.models.generators import _new_conv1d, _new_dense, gelu

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def same_padding(T: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` split for a stride-``stride`` conv of ``k`` taps over
    T frames: (lo, hi) with the extra tap on the right."""
    t_out = -(-T // stride)
    total = max((t_out - 1) * stride + k - T, 0)
    return total // 2, total - total // 2


class Critic(nn.Module):
    """score = Critic(cmp, lab, mask) ∈ R per sample; ``conv_style="time1d"``
    only."""

    def __init__(
        self,
        vocoder: VocoderConfig,
        label_dim: int,
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
        if conv_style == "2d":
            raise NotImplementedError(
                "critic conv_style='2d' is not ported yet (ROADMAP: modules "
                "still to port, models)"
            )
        if conv_style != "time1d":
            raise ValueError(f"unknown conv_style: {conv_style}")
        if norm not in ("layer", "none"):
            raise ValueError(f"unknown critic norm: {norm}")
        g = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.streams = dict(vocoder.streams)
        self.spec_key = "spec" if "spec" in self.streams else "mel"
        self.blocks = blocks
        self.kernel_time = kernel[0]
        self.norm = norm
        self.total_stride = 2 ** ((blocks + 1) // 2)  # stride 2 every other block

        a, b = self.streams[self.spec_key]
        self.spec_in = _new_dense(b - a, hidden, pdt, g)
        for i in range(blocks):
            self.add_module(f"spec_conv{i}", _new_conv1d(hidden, hidden, self.kernel_time, pdt, g))
            if norm == "layer":
                self.add_module(f"spec_ln{i}", nn.LayerNorm(hidden, eps=LN_EPS, dtype=pdt))
        self.rest = [(s, e) for name, (s, e) in self.streams.items() if name != self.spec_key]
        merge_in = hidden + hidden // 2
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

    def _layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """flax LayerNorm over the last axis of (B, T, C)."""
        ln = getattr(self, name)
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
        return ((x32 - mean) * mul + ln.bias.float()).to(self.compute_dtype)

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
        x = self._dense("spec_in", cmp[..., a:b] * m3)  # (B, T, C)
        k = self.kernel_time
        for i in range(self.blocks):
            stride = 2 if i % 2 == 0 else 1
            conv = getattr(self, f"spec_conv{i}")
            h = gelu(x).transpose(1, 2)  # (B, C, T) for the time conv
            h = F.conv1d(F.pad(h, same_padding(h.shape[-1], k, stride)),
                         conv.weight.to(dt), conv.bias.to(dt), stride=stride)
            x = h.transpose(1, 2)
            if self.norm == "layer":
                x = self._layer_norm(f"spec_ln{i}", x)

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
    the 2d style, which is not ported."""
    return Critic(
        vocoder=vocoder,
        label_dim=label_dim,
        blocks=model_cfg.critic_blocks,
        hidden=model_cfg.critic_hidden,
        kernel=(model_cfg.critic_kernel, model_cfg.critic_kernel),
        conv_style=model_cfg.conv_style,
        norm=model_cfg.critic_norm,
        compute_dtype=model_cfg.compute_dtype,
        param_dtype=model_cfg.param_dtype,
        generator=generator,
    )
