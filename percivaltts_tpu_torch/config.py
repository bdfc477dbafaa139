"""Configuration tree for experiments (the port's copy of
``percivaltts_tpu/config.py``).

Same dataclasses, fields and defaults as the JAX package's, so one
``config.json`` loads into either package to equal trees
(``tests/test_torch_imports.py``). The reasons behind each default, and the
measurements that chose them, are documented beside the JAX package's
fields; here each field carries a one-line summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class AnalysisParams:
    """Feature-defining DSP estimator and rendering conventions of the
    PML/WORLD analysis–synthesis chain (part of the feature cache key and of
    the workdir's ``config.json``)."""

    # peak/valley reader
    psync: bool = True  # pitch-synchronous exact-bin reader
    ps_periods: int = 4  # periods per resampled analysis frame
    ps_reflect: bool = False
    ps_shift: bool = False
    ps_shift_snap: bool = False
    ps_shift_nm_only: bool = False
    nm_valley_smooth: int = 0
    bap_method: str = "d4c_gd"  # WORLD bap estimator: "d4c_gd" | "peak_valley"
    nm_method: str = "d4c_gd"  # PML nm estimator: "d4c_gd" | "peak_valley"
    gd_band_hz: float = 2000.0  # coarse-band width of the group-delay statistic
    gate_nm_source: str = "peak_valley"  # "peak_valley" | "d4c"
    # rendered attack/release gate
    gate_theta: float = 0.56
    gate_min_gap: float = 1.5
    gate_edge_radius: int = 6
    edge_backfill: int = 2
    # closed-loop correction profile
    cl_boundary_radius: int = 4
    cl_clamp: float = 1.5
    cl_near_alpha: float = 0.5
    cl_near_alpha_hi: float = 0.5
    cl_near_clamp: float = 1.2
    cl_full_alpha: float = 1.1
    cl_it2_freeze_frac: float = 0.33
    cl_nm_alpha: float = 0.0
    cl_nm_clamp: float = 0.3
    # the voicing rule shared by analysis, closed loop, gate and f0_vuv
    vuv_low_frac: float = 0.25
    vuv_threshold: float = 0.75


@dataclass(frozen=True)
class VocoderConfig:
    """Vocoder feature schema: f0 (1) + warped log spectral envelope
    (``spec_size``) + warped noise mask (``nm_size``) at 16 kHz for PML."""

    kind: str = "pml"  # "pml" | "world" | "melspec"
    fs: int = 16000
    shift_ms: float = 5.0  # frame shift
    frame_ms: float = 25.0  # analysis window length (multiple of shift)
    dftlen: int = 1024  # analysis FFT length
    spec_size: int = 65  # warped log-spectral-envelope dim
    nm_size: int = 33  # warped noise-mask / aperiodicity dim
    f0_min: float = 60.0
    f0_max: float = 400.0
    envelope: str = "harmonic"  # "harmonic" | "cheaptrick" | "te"
    env_time_smooth: int = 1  # triangular time-smoothing radius (frames)
    closed_loop: int = 2  # closed-loop synthesis iterations; 0 = open loop
    mel_size: int = 80  # mel-spectrogram variant
    vuv_rule: str = "stream"  # WORLD voicing on predicted tracks: "stream" | "bap"
    vuv_bap_bands: int = 4
    vuv_bap_threshold: float = 0.60
    # PML prediction-path voicing rule override (None = the analysis rule)
    vuv_pred_low_frac: Optional[float] = None
    vuv_pred_threshold: Optional[float] = None
    analysis: AnalysisParams = field(default_factory=AnalysisParams)

    @property
    def shift_samples(self) -> int:
        return int(round(self.fs * self.shift_ms / 1000.0))

    @property
    def frame_samples(self) -> int:
        return int(round(self.fs * self.frame_ms / 1000.0))

    @property
    def feature_size(self) -> int:
        """Total per-frame output ("cmp") dimension for this vocoder."""
        if self.kind == "pml":
            return 1 + self.spec_size + self.nm_size
        if self.kind == "world":
            return 1 + 1 + self.spec_size + self.nm_size  # f0, vuv, spec, bap
        if self.kind == "melspec":
            return self.mel_size
        raise ValueError(f"unknown vocoder kind: {self.kind}")

    @property
    def streams(self) -> Dict[str, Tuple[int, int]]:
        """Name → (start, end) slices of the composed feature vector."""
        if self.kind == "pml":
            return {
                "f0": (0, 1),
                "spec": (1, 1 + self.spec_size),
                "nm": (1 + self.spec_size, 1 + self.spec_size + self.nm_size),
            }
        if self.kind == "world":
            s = self.spec_size
            return {
                "f0": (0, 1),
                "vuv": (1, 2),
                "spec": (2, 2 + s),
                "bap": (2 + s, 2 + s + self.nm_size),
            }
        if self.kind == "melspec":
            return {"mel": (0, self.mel_size)}
        raise ValueError(f"unknown vocoder kind: {self.kind}")


@dataclass(frozen=True)
class DataConfig:
    """Corpus layout + batching."""

    corpus_dir: str = ""
    fileids: str = ""  # path to the file-id list (one utterance id per line)
    label_dir: str = "label_state_align"
    wav_dir: str = "wav"
    question_file: str = ""
    num_valid: int = 5  # split by position in the file-id list
    num_test: int = 5
    batch_size: int = 32
    # static-shape buckets (frames per sequence); longer utterances are cropped
    bucket_bounds: Tuple[int, ...] = (256, 512, 768, 1024)
    label_dim: int = 425  # expected composed label dimension (declarative)
    shuffle_seed: int = 42


@dataclass(frozen=True)
class ModelConfig:
    """Generator and critic zoo."""

    generator: str = "cnn"  # "fc" | "blstm" | "bgru" | "cnn" | "cnn_blstm"
    hidden_size: int = 256
    num_layers: int = 3
    dropout_rate: float = 0.0  # training-mode dropout in the generator
    gen_norm: str = "none"  # "none" | "layer" (after the dense trunk layers)
    # CNN generator
    conv_style: str = "time1d"  # "time1d" | "2d"
    cnn_channels: int = 32
    cnn_kernel_freq: int = 5
    cnn_kernel_time: int = 5
    cnn_blocks: int = 4
    # BLSTM / BGRU generator (and the CNN generator's BiLSTM f0 head)
    blstm_size: int = 256
    blstm_layers: int = 2
    # critic
    critic_channels: int = 32
    critic_blocks: int = 4
    critic_hidden: int = 256
    critic_kernel: int = 5
    critic_norm: str = "none"  # "none" | "layer"
    # numerics: bf16 compute with f32 master weights and optimizer state
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Trainer hyperparameters."""

    trainer: str = "wgan"  # "lse" | "wgan"
    epochs: int = 100
    steps_per_epoch: int = 0  # 0 = one pass over the train set
    lr_gen: float = 1e-4
    lr_critic: float = 1e-4
    adam_b1: float = 0.5  # WGAN-GP betas
    adam_b2: float = 0.9
    # WGAN-GP
    n_critic: int = 5
    gp_lambda: float = 10.0
    gp_every: int = 1  # lazy gradient penalty: every K-th critic update, λ·K
    critic_fused_pass: bool = False  # D(real) and D(fake) in one 2B pass
    lse_weight: float = 0.25  # LSE mixing weight in the generator loss
    boundary_weight: float = 0.0  # transition-weighted LSE; 0 = plain masked MSE
    boundary_radius: int = 3
    ema_decay: float = 0.0  # EMA of the generator weights; 0 = off
    # per-stream LSE weights by vocoder stream name; empty = uniform
    stream_weights: Tuple[Tuple[str, float], ...] = ()
    measures_every: int = 0  # objective-measure validation every K epochs
    best_metric: str = "valid"  # "valid" | "mcd" | "mcd_gv"
    best_gv_weight: float = 10.0
    patience: int = 20  # early stopping
    checkpoint_every: int = 1  # epochs
    keep_checkpoints: int = 3
    data_parallel: int = 0  # data-axis size; 0 = all local devices
    transfer_dtype: str = "float32"  # host→device batch dtype
    device_corpus: bool = False  # keep the padded corpus resident on the device
    shard_corpus: bool = False
    profile_steps: int = 0
    seed: int = 123
    debug_nans: bool = False


@dataclass(frozen=True)
class Configuration:
    """Root experiment configuration."""

    workdir: str = "exp/default"
    data: DataConfig = field(default_factory=DataConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def dump(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.workdir, "config.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Configuration":
        def _known(klass, sub: Dict[str, Any], section: str) -> Dict[str, Any]:
            # configs written by other versions may carry fields this one
            # does not know: ignore them, with a note
            names = {f.name for f in dataclasses.fields(klass)}
            unknown = set(sub) - names
            if unknown:
                warnings.warn(f"config section {section!r}: ignoring unknown fields {sorted(unknown)}")
            return {k: v for k, v in sub.items() if k in names}

        def _sub(klass, key):
            sub = dict(d.get(key, {}))
            if key == "data" and "bucket_bounds" in sub:
                sub["bucket_bounds"] = tuple(sub["bucket_bounds"])
            if key == "vocoder" and isinstance(sub.get("analysis"), dict):
                ap = _known(AnalysisParams, sub["analysis"], "vocoder.analysis")
                sub["analysis"] = AnalysisParams(**ap)
            if key == "train" and "stream_weights" in sub:
                sub["stream_weights"] = tuple(
                    (str(n), float(w)) for n, w in sub["stream_weights"]
                )
            return klass(**_known(klass, sub, key))

        return cls(
            workdir=d.get("workdir", "exp/default"),
            data=_sub(DataConfig, "data"),
            vocoder=_sub(VocoderConfig, "vocoder"),
            model=_sub(ModelConfig, "model"),
            train=_sub(TrainConfig, "train"),
        )

    @classmethod
    def load(cls, path: str) -> "Configuration":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "Configuration":
        return dataclasses.replace(self, **kw)
