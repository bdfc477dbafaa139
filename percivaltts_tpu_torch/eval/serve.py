"""Label → feature serving (the semantics of ``percivaltts_tpu/eval/export.py``
``export_generator``'s graph and of ``cli synth``'s prediction step).

Raw binarized label frames in, denormalized float32 vocoder features out:
normalize with the input stats, pad with zero rows IN NORMALIZED SPACE (the
convention training batches use; a zero-padded raw input would put
``(0 - shift) * scale`` in the tail, which the BiLSTM's backward direction
reads), run the generator through ``predict_batch``, denormalize.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from torch import nn

from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.models.base import TIME_MULTIPLE, predict_batch


def serve(
    model: nn.Module,
    labs: Sequence[np.ndarray],
    in_stats: NormStats,
    out_stats: NormStats,
    chunk: int = 8,
    time_multiple: int = TIME_MULTIPLE,
) -> List[np.ndarray]:
    """``[(n_i, label_dim)]`` raw labels → ``[(n_i, feat_dim)]`` float32
    features, in request order. Requests are grouped by padded length and
    run ``chunk`` rows per generator call on the model's device."""
    labs_n = [in_stats.normalize(np.asarray(l, np.float32)).astype(np.float32) for l in labs]
    preds_n = predict_batch(model, labs_n, time_multiple=time_multiple, chunk=chunk)
    return [out_stats.denormalize(p).astype(np.float32) for p in preds_n]
