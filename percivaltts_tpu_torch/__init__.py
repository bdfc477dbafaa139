"""percivaltts_tpu_torch — the PyTorch/CUDA port of ``percivaltts_tpu``.

The JAX package beside it stays the reference: every module here keeps its
counterpart's name and is held against it by a parity test on the same
weights and inputs (``tests/test_torch_*.py``).

This first slice serves: raw HTS label frames → normalized → the CNN(+BLSTM)
generator → denormalized vocoder features (``eval/serve.py``, ``cli.py
synth``). The generator's BiLSTM recurrence runs in a hand-written CUDA
kernel (``csrc/bilstm_fwd.cu``), built with ``nvcc`` at first use
(``_build.py``). Importing the package imports neither ``jax`` nor ``flax``;
the framework-free modules of the reference (config, label binarization,
normalization stats, file I/O) are imported from it as they are.
"""

__version__ = "0.1.0"

from percivaltts_tpu.config import (  # noqa: F401
    Configuration,
    DataConfig,
    ModelConfig,
    TrainConfig,
    VocoderConfig,
)
