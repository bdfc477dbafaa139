"""percivaltts_tpu_torch — the PyTorch/CUDA port of ``percivaltts_tpu``.

The JAX package beside it stays the reference: every module here keeps its
counterpart's name and is held against it by a parity test on the same
weights and inputs (``tests/test_torch_*.py``).

Ported so far: serving (raw HTS label frames → normalized → the FC,
CNN(+BLSTM) (time-1D or the reference-faithful 2-D convs), BLSTM or BGRU
generator, each with or without LayerNorm → denormalized vocoder features
→ the PML or WORLD vocoder (every envelope and analysis reader), or
Griffin-Lim from the mel-spectrogram target → a waveform;
``eval/serve.py``, ``vocoders/``, ``cli.py synth``, from a run's best
checkpoint), training (the fused
WGAN-GP step with the conditional critic, the LSE step, and the
``Trainer``'s epochs on host-fed batches or the corpus resident on the
card, validation with the objective measures, early stopping, checkpoints
and resume; ``training/``, ``data/device_corpus.py``), and the offline
pipeline around them (the demo corpus, compose, generation and the
measures: ``data/{demo,compose}.py``, ``eval/{generate,measures}.py``,
``cli.py demo|compose|train|generate|measures``). Hand-written CUDA
kernels run the generators' recurrences (the BiLSTM forward and BPTT,
``csrc/bilstm_{fwd,bwd}.cu``; the BiGRU forward and BPTT,
``csrc/bigru_{fwd,bwd}.cu``) and the vocoder's framing and overlap-add
(``csrc/{frame_window,overlap_add}.cu``), built with ``nvcc`` at first use
(``_build.py``). The package imports nothing of ``jax``, ``flax`` or
``percivaltts_tpu``: it keeps its own copies of the framework-free modules
(``config.py``, ``data/{dataset,demo,hts_labels,normalize}.py``,
``ops/warp.py``, ``utils/{fileio,logging,prefetch}.py``).
"""

__version__ = "0.1.0"

from percivaltts_tpu_torch.config import (  # noqa: F401
    Configuration,
    DataConfig,
    ModelConfig,
    TrainConfig,
    VocoderConfig,
)
