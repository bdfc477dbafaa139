"""percivaltts_tpu_torch — the PyTorch/CUDA port of ``percivaltts_tpu``.

The JAX package beside it stays the reference: every module here keeps its
counterpart's name and is held against it by a parity test on the same
weights and inputs (``tests/test_torch_*.py``).

Ported so far: serving (raw HTS label frames → normalized → the
CNN(+BLSTM) generator → denormalized vocoder features; ``eval/serve.py``,
``cli.py synth``) and the training steps (the fused WGAN-GP step with the
conditional critic, and the LSE step; ``training/``). The generator's
BiLSTM recurrence runs in hand-written CUDA kernels, forward
(``csrc/bilstm_fwd.cu``) and BPTT (``csrc/bilstm_bwd.cu``), built with
``nvcc`` at first use (``_build.py``). Importing the package imports
neither ``jax`` nor ``flax``;
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
