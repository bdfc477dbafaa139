"""Fused bidirectional LSTM (counterpart of ``percivaltts_tpu/models/rnn.py``).

Parameters keep the JAX package's layout so the recurrence sees exactly what
the Pallas kernel sees: per direction an input kernel ``wi`` (D, 4H), a
recurrent kernel ``wh`` (H, 4H) and one bias ``b`` (4H,), gates concatenated
in the order i, f, g, o. ``weights.py`` maps flax's per-gate ``i{c}`` /
``h{c}`` / ``b{c}`` leaves onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from percivaltts_tpu_torch.models.base import dtype_by_name, lecun_normal_
from percivaltts_tpu_torch.ops.lstm_cuda import bilstm, bilstm_core

_GATES = "ifgo"


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
        for g in range(len(_GATES)):  # flax draws each gate's block on its own
            lecun_normal_(self.wi.data[:, g * H : (g + 1) * H], in_dim, generator)
            nn.init.orthogonal_(self.wh.data[:, g * H : (g + 1) * H], generator=generator)


class BiLSTM(nn.Module):
    """``(B, T, D)`` → ``(B, T, 2·features)``; both directions in one
    recurrence launch. Only ``cell_type="lstm"`` is ported."""

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
        if cell_type != "lstm":
            raise NotImplementedError(
                f"cell_type={cell_type!r} is not ported yet (ROADMAP: TPU "
                "kernels still to port, #3 _gru_fwd_kernel)"
            )
        generator = generator or torch.Generator().manual_seed(0)
        pdt = dtype_by_name(param_dtype)
        self.features = features
        self.compute_dtype = dtype_by_name(compute_dtype)
        self.fwd = LSTMDirParams(in_dim, features, pdt, generator)
        self.bwd = LSTMDirParams(in_dim, features, pdt, generator)
        # the recurrence: the forward kernel, paired with the BPTT kernel when
        # a gradient is needed (tests and chip_smoke.py swap in
        # ops.lstm_cuda.bilstm_core_reference, or bilstm_fwd_reference under
        # no_grad, to compare against the plain twins)
        self.core = bilstm_core

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        f, b = self.fwd, self.bwd
        return bilstm(
            x.to(dt),
            f.wi.to(dt), f.wh.to(dt), f.b.to(dt),
            b.wi.to(dt), b.wh.to(dt), b.b.to(dt),
            core=self.core,
        )
