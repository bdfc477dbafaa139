"""Generators (counterpart of ``percivaltts_tpu/models/generators.py``).

``FCGenerator``, ``CNNGenerator`` (``conv_style="time1d"`` or the
reference-faithful ``"2d"``, with or without the BiLSTM f0 head),
``BLSTMGenerator`` (BLSTM or BGRU layers), each with ``norm`` ``"none"`` or
``"layer"``, and ``build_generator`` for ``"fc"`` / ``"cnn"`` /
``"cnn_blstm"`` / ``"blstm"`` / ``"bgru"``. Layer names are the flax module
names (``dense_0``, ``reg_0_ln``, ``trunk_0``, ``spec_seed``,
``spec_conv0a``, ``f0_blstm``, ``frontend``, ``reg_fe_ln``, ``blstm_0``,
``out``, …) so ``weights.py`` maps one tree onto the other by path.

Parity notes, each pinned by a test:
* flax ``nn.gelu`` is the tanh approximation; torch's default GELU is erf.
* flax Conv is channels-last with ``SAME`` padding (lo = (k-1)//2 on each
  axis); here the conv stacks run on (B, C, T) or (B, C, T, freq) with that
  padding made explicit.
* flax LayerNorm (``models/base.py::layer_norm``): f32 statistics, eps 1e-6.
* streams are concatenated in their start order, then cast to float32.
* Like flax ``dtype=dt, param_dtype=pdt`` layers, parameters are stored in
  the param dtype and cast to the compute dtype at each call.

``forward(lab, train=True, generator=g)`` is training mode: with
``ModelConfig.dropout_rate`` > 0, inverted dropout follows each trunk Dense
(after its LayerNorm, before its tanh), as flax ``nn.Dropout`` in the JAX
package's ``_reg``, and, in ``BLSTMGenerator``, each recurrent layer; its
keep mask is drawn from the explicit ``torch.Generator`` ``g``. Eval mode
(the default) never drops. ``rows=(rank, ranks, groups)`` says the batch is
one data-parallel rank's share of a global batch (see :func:`dropout`), so
the masks are those world size 1 draws for the same rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from percivaltts_tpu_torch.config import ModelConfig, VocoderConfig
from percivaltts_tpu_torch.models.base import (
    LN_EPS,
    dtype_by_name,
    layer_norm,
    lecun_normal_,
    same_padding,
)
from percivaltts_tpu_torch.models.rnn import BiLSTM


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


# ``rows`` of a batch that is the whole global batch (world size 1)
ONE_RANK = (0, 1, 1)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            rows: Tuple[int, int, int] = ONE_RANK) -> torch.Tensor:
    """flax ``nn.Dropout`` in training mode: keep each element with
    probability 1 − rate and scale the kept ones by 1 / (1 − rate).

    ``rows=(rank, ranks, groups)``: x's rows are rank ``rank``'s share of a
    global batch split evenly over ``ranks`` ranks, made of ``groups``
    stacked blocks (block-major, as ``(groups, B)`` reshaped to
    ``groups·B`` rows); the draw is made over the global rows and cut to
    this rank's, so every rank advances ``generator`` alike."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    rank, ranks, groups = rows
    b = x.shape[0] // groups
    u = torch.rand((groups, b * ranks) + x.shape[1:], generator=generator, device=x.device)
    u = u[:, rank * b:(rank + 1) * b].reshape(x.shape)
    kept = u < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _new_dense(in_dim: int, out_dim: int, dtype, generator) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, dtype=dtype)
    lecun_normal_(lin.weight.data, in_dim, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _new_conv1d(channels_in: int, channels_out: int, k: int, dtype, generator) -> nn.Conv1d:
    conv = nn.Conv1d(channels_in, channels_out, k, dtype=dtype)
    lecun_normal_(conv.weight.data, k * channels_in, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _new_conv2d(channels_in: int, channels_out: int, kernel: Tuple[int, int], dtype,
                generator) -> nn.Conv2d:
    conv = nn.Conv2d(channels_in, channels_out, tuple(kernel), dtype=dtype)
    lecun_normal_(conv.weight.data, kernel[0] * kernel[1] * channels_in, generator)
    nn.init.zeros_(conv.bias)
    return conv


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor, dtype, stride: int = 1) -> torch.Tensor:
    """A flax ``Conv(padding="SAME", strides=(stride, stride))`` on
    (B, C, H, W): XLA's split on each axis, the parameters cast to
    ``dtype``."""
    kh, kw = conv.kernel_size
    x = F.pad(x, same_padding(x.shape[-1], kw, stride) + same_padding(x.shape[-2], kh, stride))
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=stride)


def _add_reg(module: nn.Module, name: str, norm: str, width: int, dtype) -> None:
    """The parameters of the JAX package's ``_reg`` point ``name``: a flax
    LayerNorm ``{name}_ln`` when ``norm="layer"``, nothing for ``"none"``."""
    if norm == "layer":
        module.add_module(f"{name}_ln", nn.LayerNorm(width, eps=LN_EPS, dtype=dtype))
    elif norm != "none":
        raise ValueError(f"unknown gen_norm: {norm}")


def _reg(module: nn.Module, name: str, x: torch.Tensor, drop: bool, generator,
         rows) -> torch.Tensor:
    """The JAX package's ``_reg``: the LayerNorm ``{name}_ln`` if the module
    has one, then dropout when ``drop``."""
    ln = getattr(module, f"{name}_ln", None)
    if ln is not None:
        x = layer_norm(x, ln.weight, ln.bias, ln.eps)
    if drop:
        x = dropout(x, module.dropout_rate, generator, rows)
    return x


def _dropout_on(train: bool, rate: float, generator) -> bool:
    """Whether dropout is on; training-mode dropout needs the generator."""
    drop = train and rate > 0.0
    if drop and generator is None:
        raise ValueError("training-mode dropout needs an explicit torch.Generator")
    return drop


def _dense(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense(dtype=dt, param_dtype=pdt)``: f32 parameters cast to
    the module's compute dtype at each call."""
    lin = getattr(module, name)
    dt = module.compute_dtype
    return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))


class FCGenerator(nn.Module):
    """Frame-wise MLP: ``num_layers`` × (Dense → [LayerNorm] → dropout →
    tanh), then a linear readout to ``feat_dim`` features."""

    def __init__(
        self,
        feat_dim: int,
        label_dim: int,
        hidden_size: int = 256,
        num_layers: int = 3,
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        norm: str = "none",
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        d = label_dim
        for i in range(num_layers):
            self.add_module(f"dense_{i}", _new_dense(d, hidden_size, pdt, g))
            _add_reg(self, f"reg_{i}", norm, hidden_size, pdt)
            d = hidden_size
        self.out = _new_dense(d, feat_dim, pdt, g)

    def forward(
        self,
        lab: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        rows: Tuple[int, int, int] = ONE_RANK,
    ) -> torch.Tensor:
        """(B, T, label_dim) normalized labels → (B, T, feat_dim) float32.
        ``train`` turns dropout on; it then draws from ``generator``, which
        must lie on the labels' device."""
        drop = _dropout_on(train, self.dropout_rate, generator)
        x = lab.to(self.compute_dtype)
        for i in range(self.num_layers):
            x = _reg(self, f"reg_{i}", _dense(self, f"dense_{i}", x), drop, generator, rows)
            x = torch.tanh(x)
        return _dense(self, "out", x).float()


class BLSTMGenerator(nn.Module):
    """Dense tanh front end (with its ``reg_fe`` LayerNorm when ``norm`` is
    ``"layer"``) → stacked bidirectional recurrent layers (LSTM, or GRU with
    ``cell_type="gru"``) of ``hidden_size // 2`` units per direction, with
    no norm between them → linear readout to ``feat_dim`` features."""

    def __init__(
        self,
        feat_dim: int,
        label_dim: int,
        hidden_size: int = 256,
        num_layers: int = 2,
        cell_type: str = "lstm",
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        norm: str = "none",
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.frontend = _new_dense(label_dim, hidden_size, pdt, g)
        _add_reg(self, "reg_fe", norm, hidden_size, pdt)
        H = hidden_size // 2
        d = hidden_size
        for i in range(num_layers):
            self.add_module(f"blstm_{i}", BiLSTM(d, H, compute_dtype, param_dtype,
                                                 cell_type=cell_type, generator=g))
            d = 2 * H
        self.out = _new_dense(d, feat_dim, pdt, g)

    def forward(
        self,
        lab: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        rows: Tuple[int, int, int] = ONE_RANK,
    ) -> torch.Tensor:
        """(B, T, label_dim) normalized labels → (B, T, feat_dim) float32.
        ``train`` turns dropout on (after the front end and after each
        recurrent layer); it then draws from ``generator``, which must lie
        on the labels' device."""
        drop = _dropout_on(train, self.dropout_rate, generator)
        x = _dense(self, "frontend", lab.to(self.compute_dtype))
        x = torch.tanh(_reg(self, "reg_fe", x, drop, generator, rows))
        for i in range(self.num_layers):
            x = getattr(self, f"blstm_{i}")(x)
            if drop:
                x = dropout(x, self.dropout_rate, generator, rows)
        return _dense(self, "out", x).float()


class CNNGenerator(nn.Module):
    """Dense tanh trunk (each layer with its ``reg_{i}`` LayerNorm when
    ``norm`` is ``"layer"``) → per-stream heads: an f0 head, optionally
    behind a BiLSTM; small dense heads for vuv and nm/bap; the spectral
    stream from residual conv blocks, either time-1D at the trunk's width
    (``conv_style="time1d"``) or, reference-faithful (``"2d"``), 2-D convs
    of ``channels`` channels over the stream rendered as a (T, freq, 2)
    image by the ``spec_seed`` Dense."""

    def __init__(
        self,
        vocoder: VocoderConfig,
        label_dim: int,
        hidden_size: int = 256,
        trunk_layers: int = 2,
        channels: int = 32,
        blocks: int = 4,
        kernel: Tuple[int, int] = (5, 5),
        conv_style: str = "time1d",
        use_blstm_heads: bool = False,
        blstm_size: int = 128,
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        norm: str = "none",
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if conv_style not in ("time1d", "2d"):
            raise ValueError(f"unknown conv_style: {conv_style}")
        g = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.streams = dict(vocoder.streams)
        self.trunk_layers = trunk_layers
        self.dropout_rate = dropout_rate
        self.blocks = blocks
        self.conv_style = conv_style
        self.kernel_time = kernel[0]
        Hd = hidden_size

        d = label_dim
        for i in range(trunk_layers):
            self.add_module(f"trunk_{i}", _new_dense(d, Hd, pdt, g))
            _add_reg(self, f"reg_{i}", norm, Hd, pdt)
            d = Hd
        self.f0_blstm = None
        if "f0" in self.streams:
            f0_in = Hd
            if use_blstm_heads:
                self.f0_blstm = BiLSTM(Hd, blstm_size, compute_dtype, param_dtype, generator=g)
                f0_in = 2 * blstm_size
            self.f0_out = _new_dense(f0_in, 1, pdt, g)
        if "vuv" in self.streams:
            self.vuv_out = _new_dense(Hd, 1, pdt, g)
        self.spec_key = "spec" if "spec" in self.streams else "mel"
        a, b = self.streams[self.spec_key]
        self.spec_size = b - a
        if conv_style == "2d":
            self.spec_seed = _new_dense(Hd, 2 * self.spec_size, pdt, g)
            self.spec_in = _new_conv2d(2, channels, kernel, pdt, g)
            for i in range(blocks):
                self.add_module(f"spec_conv{i}a", _new_conv2d(channels, channels, kernel, pdt, g))
                self.add_module(f"spec_conv{i}b", _new_conv2d(channels, channels, kernel, pdt, g))
            self.spec_out = _new_conv2d(channels, 1, kernel, pdt, g)
        else:
            for i in range(blocks):
                self.add_module(f"spec_conv{i}a", _new_conv1d(Hd, Hd, self.kernel_time, pdt, g))
                self.add_module(f"spec_conv{i}b", _new_conv1d(Hd, Hd, self.kernel_time, pdt, g))
            self.spec_out = _new_dense(Hd, self.spec_size, pdt, g)
        for name in ("nm", "bap"):
            if name in self.streams:
                a, b = self.streams[name]
                self.add_module(f"{name}_hidden", _new_dense(Hd, Hd // 2, pdt, g))
                self.add_module(f"{name}_out", _new_dense(Hd // 2, b - a, pdt, g))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T) → (B, C, T); flax ``SAME`` padding at stride 1."""
        conv = getattr(self, name)
        dt = self.compute_dtype
        k = self.kernel_time
        x = F.pad(x, ((k - 1) // 2, k - 1 - (k - 1) // 2))
        return F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt))

    def _spec_2d(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, hidden) trunk output → (B, T, spec_size): the ``spec_seed``
        image (B, T, spec_size, 2), its trailing 2 the fastest axis as in
        flax, run as (B, 2, T, spec_size) through the residual 2-D convs."""
        dt = self.compute_dtype
        B, T = x.shape[:2]
        img = torch.tanh(_dense(self, "spec_seed", x))
        img = img.reshape(B, T, self.spec_size, 2).permute(0, 3, 1, 2)
        img = conv2d_same(self.spec_in, img, dt)
        for i in range(self.blocks):
            r = conv2d_same(getattr(self, f"spec_conv{i}a"), gelu(img), dt)
            r = conv2d_same(getattr(self, f"spec_conv{i}b"), gelu(r), dt)
            img = img + r
        return conv2d_same(self.spec_out, img, dt)[:, 0]

    def forward(
        self,
        lab: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        rows: Tuple[int, int, int] = ONE_RANK,
    ) -> torch.Tensor:
        """(B, T, label_dim) normalized labels → (B, T, feat_dim) float32.
        ``train`` turns dropout on; it then draws from ``generator``, which
        must lie on the labels' device."""
        drop = _dropout_on(train, self.dropout_rate, generator)
        x = lab.to(self.compute_dtype)
        for i in range(self.trunk_layers):
            x = _reg(self, f"reg_{i}", _dense(self, f"trunk_{i}", x), drop, generator, rows)
            x = torch.tanh(x)

        outs = {}
        if "f0" in self.streams:
            h = x if self.f0_blstm is None else self.f0_blstm(x)
            outs["f0"] = _dense(self, "f0_out", h)
        if "vuv" in self.streams:
            outs["vuv"] = _dense(self, "vuv_out", x)

        if self.conv_style == "2d":
            outs[self.spec_key] = self._spec_2d(x)
        else:
            h = x.transpose(1, 2)  # (B, C, T) for the time convs
            for i in range(self.blocks):
                r = self._conv(f"spec_conv{i}a", gelu(h))
                r = self._conv(f"spec_conv{i}b", gelu(r))
                h = h + r
            outs[self.spec_key] = _dense(self, "spec_out", h.transpose(1, 2))

        for name in ("nm", "bap"):
            if name in self.streams:
                hn = torch.tanh(_dense(self, f"{name}_hidden", x))
                outs[name] = _dense(self, f"{name}_out", hn)

        order = sorted(self.streams.items(), key=lambda kv: kv[1][0])
        return torch.cat([outs[n] for n, _ in order], dim=-1).float()


def build_generator(
    model_cfg: ModelConfig,
    vocoder: VocoderConfig,
    label_dim: int,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Config → generator module, its parameters drawn on the CPU from
    ``generator`` (seed 0 when omitted) with flax's init rules; move it to
    the device with ``.to(device)``."""
    kind = model_cfg.generator
    if kind == "fc":
        return FCGenerator(
            feat_dim=vocoder.feature_size,
            label_dim=label_dim,
            hidden_size=model_cfg.hidden_size,
            num_layers=model_cfg.num_layers,
            compute_dtype=model_cfg.compute_dtype,
            param_dtype=model_cfg.param_dtype,
            norm=model_cfg.gen_norm,
            dropout_rate=model_cfg.dropout_rate,
            generator=generator,
        )
    if kind in ("blstm", "bgru"):
        return BLSTMGenerator(
            feat_dim=vocoder.feature_size,
            label_dim=label_dim,
            hidden_size=model_cfg.blstm_size,
            num_layers=model_cfg.blstm_layers,
            cell_type="gru" if kind == "bgru" else "lstm",
            compute_dtype=model_cfg.compute_dtype,
            param_dtype=model_cfg.param_dtype,
            norm=model_cfg.gen_norm,
            dropout_rate=model_cfg.dropout_rate,
            generator=generator,
        )
    if kind in ("cnn", "cnn_blstm"):
        return CNNGenerator(
            vocoder=vocoder,
            label_dim=label_dim,
            hidden_size=model_cfg.hidden_size,
            channels=model_cfg.cnn_channels,
            blocks=model_cfg.cnn_blocks,
            kernel=(model_cfg.cnn_kernel_time, model_cfg.cnn_kernel_freq),
            conv_style=model_cfg.conv_style,
            use_blstm_heads=(kind == "cnn_blstm"),
            blstm_size=model_cfg.blstm_size // 2,
            compute_dtype=model_cfg.compute_dtype,
            param_dtype=model_cfg.param_dtype,
            norm=model_cfg.gen_norm,
            dropout_rate=model_cfg.dropout_rate,
            generator=generator,
        )
    raise ValueError(f"unknown generator kind: {kind}")
