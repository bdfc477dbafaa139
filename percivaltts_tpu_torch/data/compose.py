"""Corpus feature composition: labels + vocoder analysis → training features
(counterpart of ``percivaltts_tpu/data/compose.py``).

Per utterance in the file-id list, the HTS label is binarized through the
question set and the waveform is analyzed by the configured vocoder (PML,
WORLD or the mel spectrogram, on the card, in chunks of 8 utterances: one
batched call a chunk); then the corpus normalization statistics are
computed over the training split and the normalized datasets are built.
Features are cached
per utterance as headerless float32 files beside a ``cache_meta.json``
that equals the JAX package's, so a cache composed by either package
serves the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset, split_fileids
from percivaltts_tpu_torch.data.hts_labels import (
    NUM_FRAME_FEATURES,
    QuestionSet,
    binarize_label_file,
)
from percivaltts_tpu_torch.data.normalize import NormStats, compute_meanstd, compute_minmax
from percivaltts_tpu_torch.utils.fileio import load_binary_file, save_binary_file
from percivaltts_tpu_torch.utils.logging import print_log

# utterances per batched vocoder analysis
ANALYSIS_CHUNK = 8

# the voicing DECISION rules apply to predicted tracks at generation time
# only; they do not change what analysis writes, so they are not part of
# the feature cache's key
_DECISION_ONLY = (
    "vuv_rule",
    "vuv_bap_bands",
    "vuv_bap_threshold",
    "vuv_pred_low_frac",
    "vuv_pred_threshold",
)


def load_wav(path: str) -> Tuple[int, np.ndarray]:
    """Load a wav file as float32 in [-1, 1].

    Accepts 16/24-in-32/32-bit PCM and float32/64; anything else raises
    with the fix spelled out rather than silently mis-scaling."""
    import scipy.io.wavfile as wavfile

    fs, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype != np.float32:
        raise ValueError(
            f"{path}: unsupported wav sample format {x.dtype} — convert the "
            "corpus to 16-bit PCM (e.g. `sox in.wav -b 16 out.wav`); "
            "supported: int16, int32, float32, float64"
        )
    if x.ndim > 1:
        x = x.mean(axis=1)
    return fs, x


def save_wav(path: str, fs: int, x: np.ndarray) -> None:
    """Write ``x`` (clipped to [-1, 1]) as 16-bit PCM at ``fs``."""
    import scipy.io.wavfile as wavfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xi = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    wavfile.write(path, fs, (xi * 32767.0).astype(np.int16))


def normalize_inplace(x: np.ndarray, shift: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``(x − shift)·scale`` in place on a float32 C-contiguous array (a
    converted copy otherwise), rounded after each operation: the numpy form
    of the JAX package's ``native.normalize_inplace``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    x -= shift
    x *= scale
    return x


class ComposedCorpus:
    """The output of the compose stage: datasets + normalization stats."""

    def __init__(
        self,
        train: Dataset,
        valid: Dataset,
        test: Dataset,
        in_stats: NormStats,
        out_stats: NormStats,
    ):
        self.train = train
        self.valid = valid
        self.test = test
        self.in_stats = in_stats
        self.out_stats = out_stats

    def save_stats(self, workdir: str) -> None:
        os.makedirs(workdir, exist_ok=True)
        self.in_stats.save(os.path.join(workdir, "in_stats.npz"))
        self.out_stats.save(os.path.join(workdir, "out_stats.npz"))


def _cache_meta(cfg: Configuration, questions: QuestionSet) -> dict:
    """What the cached features depend on: the vocoder config (without the
    decision-only voicing rules) and the question set."""
    voc_meta = dataclasses.asdict(cfg.vocoder)
    for k in _DECISION_ONLY:
        voc_meta.pop(k, None)
    return {
        "vocoder": voc_meta,
        "question_file": os.path.abspath(cfg.data.question_file),
        "questions_dim": questions.dim,
    }


def _open_cache(cache_dir: str, meta: dict, write: bool = True) -> bool:
    """Whether the cached features may be read. The writer drops them when
    ``cache_meta.json`` differs from ``meta`` (a stale cache must never
    serve features of another analysis or question set), then writes
    ``meta``; a reader (``write=False``) changes nothing and reads the
    cache only when its ``cache_meta.json`` is ``meta``."""
    meta_path = os.path.join(cache_dir, "cache_meta.json")
    current = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            current = json.load(f)
    if not write:
        return current == meta
    if current is not None and current != meta:
        print_log("feature cache is stale (vocoder/question config changed); recomputing")
        for fn in os.listdir(cache_dir):
            if fn.endswith(".f32"):
                os.remove(os.path.join(cache_dir, fn))
    os.makedirs(cache_dir, exist_ok=True)
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(meta_path + ".tmp", meta_path)
    return True


def _save_cached(path: str, arr: np.ndarray) -> None:
    """Write under a temporary name, then rename: a reader composing at the
    same time sees a cached file whole or not at all."""
    save_binary_file(path + ".tmp", arr)
    os.replace(path + ".tmp", path)


def _read_wav(cfg: Configuration, uid: str) -> np.ndarray:
    d = cfg.data
    wav_path = os.path.join(d.corpus_dir, d.wav_dir, uid + ".wav")
    if not os.path.exists(wav_path):
        raise FileNotFoundError(
            f"utterance {uid!r}: no waveform at {wav_path} — the "
            f"corpus layout is <corpus_dir>/{d.wav_dir}/<id>.wav "
            "(Merlin layout; see README 'Real corpora'); check "
            "DataConfig.corpus_dir/wav_dir and the file-id list"
        )
    fs, wav = load_wav(wav_path)
    if fs != cfg.vocoder.fs:
        raise ValueError(
            f"{wav_path}: sample rate {fs} != configured vocoder fs "
            f"{cfg.vocoder.fs} — either resample the corpus (e.g. "
            f"`sox in.wav -r {cfg.vocoder.fs} out.wav`) or set "
            f"vocoder.fs={fs} in the config (48 kHz sources are "
            "common; analysis conventions are fs-aware)"
        )
    return wav


def _read_label(cfg: Configuration, uid: str, questions: QuestionSet, n_acoustic: int):
    """The binarized label of ``uid``; warns when its frame count and the
    acoustic one disagree by more than 100 ms and 5% (a wrong alignment or
    shift; the overhang is cropped when batching)."""
    d = cfg.data
    lab_path = os.path.join(d.corpus_dir, d.label_dir, uid + ".lab")
    if not os.path.exists(lab_path):
        raise FileNotFoundError(
            f"utterance {uid!r}: no HTS label at {lab_path} — the "
            f"corpus layout is <corpus_dir>/{d.label_dir}/<id>.lab "
            "(state- or phone-aligned full-context labels with HTK "
            "100 ns times); set DataConfig.label_dir if the corpus "
            "uses a different directory (Merlin: label_state_align "
            "or label_phone_align)"
        )
    lab = binarize_label_file(lab_path, questions, cfg.vocoder.shift_ms / 1000.0)
    nl, nc = lab.shape[0], n_acoustic
    if abs(nl - nc) > max(20, int(0.05 * max(nl, nc))):
        print_log(
            f"WARNING utterance {uid!r}: label frames ({nl}) and "
            f"acoustic frames ({nc}) disagree by {abs(nl - nc)} "
            f"(> 100 ms and > 5%) — check that {lab_path} aligns "
            f"this exact audio and that vocoder.shift_ms "
            f"({cfg.vocoder.shift_ms}) matches the alignment's "
            "frame shift; the overhang will be cropped"
        )
    return lab


def compose(
    cfg: Configuration,
    fileids: Optional[Sequence[str]] = None,
    cache_dir: Optional[str] = None,
    normalize: bool = True,
    device="cuda",
    write_cache: bool = True,
) -> ComposedCorpus:
    """Run the composition stage over the corpus in ``cfg.data``, analyzing
    on ``device`` (the card unless the caller names another).

    Min/max stats for the binary-heavy label inputs, mean/std stats for the
    acoustic targets with the bounded [0, 1] streams (PML's noise mask,
    WORLD's vuv and band aperiodicity) left as they are, all
    over the training split. With ``normalize=False`` the datasets stay raw
    and the stats are applied on the device inside the train step
    (``training/ondevice.py``). ``write_cache=False`` reads ``cache_dir``
    and writes nothing there: the data-parallel ranks compose at once, and
    rank 0 alone writes the cache."""
    from percivaltts_tpu_torch.vocoders import get_vocoder

    d = cfg.data
    voc = get_vocoder(cfg.vocoder, device)
    questions = QuestionSet.from_hed(d.question_file)

    if fileids is None:
        with open(d.fileids) as f:
            fileids = [line.strip() for line in f if line.strip()]
    if cache_dir and not _open_cache(cache_dir, _cache_meta(cfg, questions), write_cache):
        cache_dir = None

    qdim = questions.dim + NUM_FRAME_FEATURES
    labs: dict = {}
    cmps: dict = {}
    uncached: List[str] = []
    for uid in fileids:
        cached_lab = cache_dir and os.path.join(cache_dir, uid + ".lab.f32")
        cached_cmp = cache_dir and os.path.join(cache_dir, uid + ".cmp.f32")
        if cache_dir and os.path.exists(cached_lab) and os.path.exists(cached_cmp):
            labs[uid] = load_binary_file(cached_lab, qdim)
            cmps[uid] = load_binary_file(cached_cmp, voc.feature_size)
        else:
            uncached.append(uid)

    for k in range(0, len(uncached), ANALYSIS_CHUNK):
        chunk = uncached[k : k + ANALYSIS_CHUNK]
        wavs = [_read_wav(cfg, uid) for uid in chunk]
        for uid, cmp_ in zip(chunk, voc.analyze_batch(wavs)):
            cmps[uid] = cmp_
            labs[uid] = _read_label(cfg, uid, questions, cmp_.shape[0])
            if cache_dir and write_cache:
                _save_cached(os.path.join(cache_dir, uid + ".lab.f32"), labs[uid])
                _save_cached(os.path.join(cache_dir, uid + ".cmp.f32"), cmp_)
    labs = [labs[uid] for uid in fileids]
    cmps = [cmps[uid] for uid in fileids]
    print_log(f"composed {len(fileids)} utterances ({len(uncached)} analyzed)")

    full = Dataset(labs=labs, cmps=cmps, ids=list(fileids))
    tr_ids, va_ids, te_ids = split_fileids(list(fileids), d.num_valid, d.num_test)
    train = full.subset(tr_ids)

    in_stats = compute_minmax(train.labs)
    # bounded [0, 1] streams stay as they are: PML's nm, WORLD's vuv and bap
    keep = [voc.streams[k] for k in ("nm", "vuv", "bap") if k in voc.streams]
    out_stats = compute_meanstd(train.cmps, keep_streams=keep)

    if d.label_dim > 0 and full.label_dim != d.label_dim:
        print_log(
            f"note: composed label dim {full.label_dim} != configured "
            f"data.label_dim {d.label_dim} (the composed value is "
            f"authoritative; the config field is declarative)"
        )

    def norm(ds: Dataset) -> Dataset:
        if not normalize:
            return ds
        return Dataset(
            labs=[normalize_inplace(x, in_stats.shift, in_stats.scale) for x in ds.labs],
            cmps=[normalize_inplace(x, out_stats.shift, out_stats.scale) for x in ds.cmps],
            ids=ds.ids,
        )

    return ComposedCorpus(
        train=norm(train),
        valid=norm(full.subset(va_ids)),
        test=norm(full.subset(te_ids)),
        in_stats=in_stats,
        out_stats=out_stats,
    )
