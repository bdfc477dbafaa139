"""Fused bidirectional LSTM / GRU (counterpart of ``percivaltts_tpu/models/rnn.py``).

Parameters keep the JAX package's layout so the recurrence sees exactly what
the Pallas kernels see. LSTM, per direction: an input kernel ``wi`` (D, 4H),
a recurrent kernel ``wh`` (H, 4H) and one bias ``b`` (4H,), gates
concatenated in the order i, f, g, o. GRU, per direction: ``wi`` (D, 3H),
``wh`` (H, 3H), the input-projection bias ``b`` (3H,) and the recurrent
n-branch bias ``bn`` (H,), gates in the order r, z, n. ``weights.py`` maps
flax's per-gate ``i{c}`` / ``h{c}`` / ``b{c}`` (and ``bhn``) leaves onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from percivaltts_tpu_torch.models.base import dtype_by_name, lecun_normal_
from percivaltts_tpu_torch.ops.gru_cuda import bigru, bigru_core
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm, bilstm_core

_GATES = "ifgo"
_GRU_GATES = "rzn"


def _init_gate_blocks(wi: torch.Tensor, wh: torch.Tensor, in_dim: int, H: int,
                      n_gates: int, generator: torch.Generator) -> None:
    """flax's rules, each gate's block drawn on its own: lecun-normal input
    kernels, orthogonal (H, H) recurrent kernels."""
    for g in range(n_gates):
        lecun_normal_(wi.data[:, g * H : (g + 1) * H], in_dim, generator)
        nn.init.orthogonal_(wh.data[:, g * H : (g + 1) * H], generator=generator)


class LSTMDirParams(nn.Module):
    """One direction's parameters with flax ``OptimizedLSTMCell``'s init
    rules: lecun-normal input kernels, an orthogonal (H, H) recurrent kernel
    per gate, zero biases."""

    def __init__(self, in_dim: int, features: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        H = features
        self.wi = nn.Parameter(torch.empty(in_dim, 4 * H, dtype=dtype))
        self.wh = nn.Parameter(torch.empty(H, 4 * H, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(4 * H, dtype=dtype))
        _init_gate_blocks(self.wi, self.wh, in_dim, H, len(_GATES), generator)


class GRUDirParams(nn.Module):
    """One direction's parameters with flax ``GRUCell``'s init rules, per
    gate r, z, n: lecun-normal input kernels, orthogonal recurrent kernels,
    zero input-projection biases ``b{c}`` and a zero recurrent n-branch bias
    ``bhn``."""

    def __init__(self, in_dim: int, features: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        H = features
        self.wi = nn.Parameter(torch.empty(in_dim, 3 * H, dtype=dtype))
        self.wh = nn.Parameter(torch.empty(H, 3 * H, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(3 * H, dtype=dtype))
        self.bn = nn.Parameter(torch.zeros(H, dtype=dtype))
        _init_gate_blocks(self.wi, self.wh, in_dim, H, len(_GRU_GATES), generator)


class BiLSTM(nn.Module):
    """``(B, T, D)`` → ``(B, T, 2·features)``; both directions in one
    recurrence launch. ``cell_type="gru"`` is the BGRU variant."""

    def __init__(
        self,
        in_dim: int,
        features: int,
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        cell_type: str = "lstm",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"unknown cell_type: {cell_type!r}")
        generator = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.features = features
        self.cell_type = cell_type
        self.compute_dtype = dtype_by_name(compute_dtype)
        params = GRUDirParams if cell_type == "gru" else LSTMDirParams
        self.fwd = params(in_dim, features, pdt, generator)
        self.bwd = params(in_dim, features, pdt, generator)
        # the recurrence: the forward kernel, paired with the BPTT kernel when
        # a gradient is needed (tests and chip_smoke.py swap in the
        # *_core_reference of ops.lstm_cuda / ops.gru_cuda, or the
        # *_fwd_reference under no_grad, to compare against the plain twins)
        self.core = bigru_core if cell_type == "gru" else bilstm_core

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        f, b = self.fwd, self.bwd
        if self.cell_type == "gru":
            return bigru(
                x.to(dt),
                f.wi.to(dt), f.wh.to(dt), f.b.to(dt), f.bn.to(dt),
                b.wi.to(dt), b.wh.to(dt), b.b.to(dt), b.bn.to(dt),
                core=self.core,
            )
        return bilstm(
            x.to(dt),
            f.wi.to(dt), f.wh.to(dt), f.b.to(dt),
            b.wi.to(dt), b.wh.to(dt), b.b.to(dt),
            core=self.core,
        )
