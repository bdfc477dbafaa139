"""The port's operators. Importing this package registers the kernels
#1, #3, #5 and #6 as ``torch.library`` operators under ``percival::``
(``bilstm_fwd``, ``bigru_fwd``, ``frame_window``, ``overlap_add``), which
an exported graph (``eval/export.py``) needs before it is loaded."""

from percivaltts_tpu_torch.ops import frames_cuda, gru_cuda, lstm_cuda  # noqa: F401
