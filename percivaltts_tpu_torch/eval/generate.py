"""Generation stage: predict → denormalize → objective measures → optional
feature files and waveforms (counterpart of
``percivaltts_tpu/eval/generate.py``).

The whole split runs in batched device calls: stacked-chunk generator
predictions (``models.base.predict_batch``) from the state's evaluation
weights (its EMA when the run keeps one), one cepstra transform per chunk
of 16 (prediction, reference) pairs, and chunked vocoder synthesis
(``Vocoder.synthesize_batch``). The per-utterance measures (equal weight
per utterance) aggregate on the host in numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset
from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.eval.measures import (
    global_variance_ratio,
    modulation_spectrum_ratio,
    per_frame_mcd_np,
)
from percivaltts_tpu_torch.models.base import predict_batch
from percivaltts_tpu_torch.training.state import GANState, eval_generator
from percivaltts_tpu_torch.utils.fileio import save_binary_file
from percivaltts_tpu_torch.utils.logging import print_log

# (prediction, reference) pairs per cepstra call
CEPSTRA_CHUNK = 16


def generate(
    cfg: Configuration,
    state: GANState,
    dataset: Dataset,
    out_stats: NormStats,
    outdir: Optional[str] = None,
    synthesize: bool = True,
    save_features: bool = False,
) -> Dict[str, float]:
    """Run generation over ``dataset`` (normalized features) on the state's
    device and return the aggregated objective measures: ``mcd_db``,
    ``gv_ratio``, ``ms_ratio_bands``, ``ms_ratio_hi`` and, where the
    vocoder reads voicing, ``f0_rmse_hz`` and ``vuv_error_pct``. Writes
    ``<uid>.cmp`` (denormalized predictions) with ``save_features`` and
    ``<uid>.wav`` with ``synthesize`` under ``outdir``."""
    from percivaltts_tpu_torch.vocoders import get_vocoder

    device = next(state.gen.parameters()).device
    voc = get_vocoder(cfg.vocoder, device)
    outdir = outdir or os.path.join(cfg.workdir, "generated")
    os.makedirs(outdir, exist_ok=True)
    if len(dataset.ids) == 0:
        raise ValueError("generate(): the requested split has no utterances")

    preds_n = predict_batch(eval_generator(state), dataset.labs)
    preds, refs, ns = [], [], []
    for i in range(len(dataset.ids)):
        pred = out_stats.denormalize(preds_n[i]).astype(np.float32)
        ref = out_stats.denormalize(dataset.cmps[i]).astype(np.float32)
        preds.append(pred)
        refs.append(ref)
        ns.append(min(pred.shape[0], ref.shape[0]))

    # one cepstra call per chunk of pairs, each padded to the chunk's
    # longest, bounds the host and device memory of a large split
    ceps: list = []
    for c0 in range(0, len(ns), CEPSTRA_CHUNK):
        cn = ns[c0 : c0 + CEPSTRA_CHUNK]
        stack = np.zeros((2 * len(cn), max(cn), preds[0].shape[1]), np.float32)
        for j, n in enumerate(cn):
            stack[2 * j, :n] = preds[c0 + j][:n]
            stack[2 * j + 1, :n] = refs[c0 + j][:n]
        ceps.extend(voc.cepstra(stack))

    mcds, f0rs, vuvs = [], [], []
    cep_p_all, cep_r_all = [], []
    for i, n in enumerate(ns):
        mcds.append(float(np.mean(per_frame_mcd_np(ceps[2 * i][:n], ceps[2 * i + 1][:n]))))
        cep_p_all.append(ceps[2 * i][:n])
        cep_r_all.append(ceps[2 * i + 1][:n])
        try:
            f0p, vp = voc.f0_vuv_pred(preds[i][:n])
            f0r, vr = voc.f0_vuv(refs[i][:n])
        except NotImplementedError:
            continue
        both = (vp > 0.5) & (vr > 0.5)
        if both.any():
            f0rs.append(float(np.sqrt(np.mean((f0p - f0r)[both] ** 2))))
        vuvs.append(float(100.0 * np.mean((vp > 0.5) != (vr > 0.5))))

    if save_features:
        for i, uid in enumerate(dataset.ids):
            save_binary_file(os.path.join(outdir, uid + ".cmp"), preds[i])
    if synthesize:
        from percivaltts_tpu_torch.data.compose import save_wav

        for uid, wav in zip(dataset.ids, voc.synthesize_batch(preds)):
            save_wav(os.path.join(outdir, uid + ".wav"), cfg.vocoder.fs, wav)

    measures: Dict[str, float] = {"mcd_db": float(np.mean(mcds))}
    # over-smoothing: corpus-level global-variance ratio of the predicted
    # vs natural cepstra (< 1 under-dispersed, as LSE regression tends to be)
    measures["gv_ratio"] = float(global_variance_ratio(
        np.concatenate(cep_p_all, axis=0), np.concatenate(cep_r_all, axis=0)))
    # its temporal complement: the modulation-spectrum ratio in four bands
    # (1-4 / 4-10 / 10-25 / 25-50 Hz); ms_ratio_hi is the geometric mean of
    # the top two
    T, D = max(ns), cep_p_all[0].shape[1]
    sp = np.zeros((len(ns), T, D), np.float32)
    sr = np.zeros((len(ns), T, D), np.float32)
    msk = np.zeros((len(ns), T), np.float32)
    for i, n in enumerate(ns):
        sp[i, :n], sr[i, :n], msk[i, :n] = cep_p_all[i], cep_r_all[i], 1.0
    ms = modulation_spectrum_ratio(sp, sr, mask_pred=msk, mask_ref=msk,
                                   frame_rate=1000.0 / cfg.vocoder.shift_ms).numpy()
    measures["ms_ratio_bands"] = [round(float(x), 4) for x in ms]
    measures["ms_ratio_hi"] = float(np.exp(np.mean(np.log(np.maximum(ms[2:], 1e-12)))))
    # independent gates: a prediction with no both-voiced frame has no F0
    # RMSE, but its voicing disagreement is still reported
    if f0rs:
        measures["f0_rmse_hz"] = float(np.mean(f0rs))
    if vuvs:
        measures["vuv_error_pct"] = float(np.mean(vuvs))
    print_log("objective measures: " + ", ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in measures.items()))
    return measures
