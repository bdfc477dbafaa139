"""Serving export: the trained generator and the vocoder's synthesis as
``torch.export`` artifacts, served without the model or vocoder code.

Counterpart of ``percivaltts_tpu/eval/export.py``. The generator graph takes
RAW binarized label frames and returns DENORMALIZED vocoder features: input
normalization, the generator and output denormalization in one graph, the
parameters (the EMA copy when the run keeps one) held by the artifact. The
synthesis graph takes those features and returns the waveform through the
vocoder's full default synthesis, the closed loop included, with the noise
drawn at export time held as a constant of the artifact.

Each graph is exported at each bucket bound (static shapes: the recurrent
generators' kernels run over the whole time axis); a loader pads an
utterance to the smallest bound that admits it and trims the result, the
contract the training pipeline's bucketing keeps (``data/dataset.py``).

Layout under ``<workdir>/export/``::

    manifest.json      dims, bounds, batch, the vocoder's config, versions
    gen_t<bound>.pt2   label→features, one artifact per bound
    syn_t<bound>.pt2   features→waveform, one artifact per bound rounded up
                       to the vocoder's frame multiple

The graphs launch the hand-written kernels through the registered operators
``percival::bilstm_fwd`` / ``bigru_fwd`` (the generator) and
``percival::frame_window`` / ``overlap_add`` (every STFT and iSTFT of the
synthesis): a loader needs no model or vocoder code, but it needs those
registrations, which importing ``percivaltts_tpu_torch.ops`` makes (this
module does). ``ExportedSynthesizer`` also rebuilds the vocoder's host-side
``export_preprocess`` (WORLD's voicing decision) from the manifest.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export import ExportedProgram

import percivaltts_tpu_torch.ops  # noqa: F401  (registers the percival:: operators)
from percivaltts_tpu_torch import __version__ as _pkg_version
from percivaltts_tpu_torch.data.normalize import NormStats


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _rows(n_frames: torch.Tensor) -> torch.Tensor:
    """``()`` (batch 1) or ``(batch,)`` frame counts → ``(batch,)``."""
    return n_frames.reshape(-1)


def _n_frames_arg(batch: int, value: int, device) -> torch.Tensor:
    return torch.full(() if batch == 1 else (batch,), value, dtype=torch.int32, device=device)


class _GeneratorGraph(nn.Module):
    """``((batch, bound, label_dim) raw labels, n_frames)`` →
    ``(batch, bound, feat_dim)`` denormalized f32 features. ``n_frames``
    masks the pad tail to zero IN NORMALIZED SPACE, the padding training
    batches carry: a zero-padded RAW tail would normalize to
    ``(0 − shift)·scale ≠ 0``, which the recurrent layers' backward
    direction reads (``eval/serve.py``)."""

    def __init__(self, gen: nn.Module, in_stats: NormStats, out_stats: NormStats, device):
        super().__init__()
        self.gen = gen
        self.register_buffer("i_shift", _f32(in_stats.shift, device))
        self.register_buffer("i_scale", _f32(in_stats.scale, device))
        self.register_buffer("o_shift", _f32(out_stats.shift, device))
        self.register_buffer("o_scale", _f32(out_stats.scale, device))

    def forward(self, lab: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        t = torch.arange(lab.shape[1], device=lab.device)
        valid = t[None, :, None] < _rows(n_frames)[:, None, None]
        lab_n = torch.where(valid, (lab - self.i_shift) * self.i_scale, 0.0)
        return self.gen(lab_n).float() / self.o_scale + self.o_shift


def export_generator(
    gen: nn.Module,
    in_stats: NormStats,
    out_stats: NormStats,
    label_dim: int,
    bounds: Sequence[int],
    batch: int = 1,
) -> Dict[int, ExportedProgram]:
    """Label→features inference at each bucket bound → ``{bound: program}``.

    ``gen`` serves as it is, on its device (give it the EMA weights where
    the run keeps them: ``training.state.eval_generator``). Each program's
    signature is ``((batch, bound, label_dim) f32 raw labels, n_frames)`` →
    ``(batch, bound, feat_dim)`` f32 denormalized features, ``n_frames`` a
    ``()`` int32 at batch 1 (the latency artifact) or a ``(batch,)`` int32
    of row lengths above it (the throughput artifact)."""
    device = next(gen.parameters()).device
    graph = _GeneratorGraph(gen, in_stats, out_stats, device)
    out = {}
    with torch.no_grad():
        for bound in bounds:
            lab = torch.zeros((batch, int(bound), label_dim), dtype=torch.float32, device=device)
            args = (lab, _n_frames_arg(batch, int(bound), device))
            out[int(bound)] = torch.export.export(graph, args, strict=False)
    return out


class _SynthesisGraph(nn.Module):
    """``((batch, bound, F) f32 raw features, n_frames)`` → ``(batch,
    bound·hop)`` f32 samples: the pad tail refilled by the vocoder's
    convention, its tensor core, the samples past ``n_frames·hop`` zeroed."""

    def __init__(self, voc, noise: Optional[torch.Tensor]):
        super().__init__()
        self.voc = voc
        self.register_buffer("noise", noise)

    def forward(self, fp: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        nf = _rows(n_frames)
        t = torch.arange(fp.shape[1], device=fp.device)
        if self.voc.pad_fill is None:  # replicate the last real frame
            idx = torch.minimum(t[None, :], torch.clamp(nf[:, None] - 1, min=0))
            fp = torch.gather(fp, 1, idx[..., None].expand(-1, -1, fp.shape[2]))
        else:
            fp = torch.where(t[None, :, None] < nf[:, None, None], fp, self.voc.pad_fill)
        wav = self.voc.synthesize_stacked(fp, self.noise)
        samp = torch.arange(wav.shape[1], device=fp.device)
        return torch.where(samp[None, :] < nf[:, None] * self.voc.cfg.shift_samples, wav, 0.0)


def export_synthesis(voc, bounds: Sequence[int], batch: int = 1,
                     seed: int = 0) -> Dict[int, ExportedProgram]:
    """The vocoder's default synthesis (features → waveform) at each bound
    → ``{bound': program}``, ``bound'`` the bound rounded up to
    ``voc.frame_multiple``, on the vocoder's device.

    Signature: ``((batch, bound', F) f32 raw features, n_frames)`` →
    ``(batch, bound'·hop)`` f32 samples, ``n_frames`` as in
    :func:`export_generator`. WORLD features go through
    ``voc.export_preprocess`` first (``ExportedSynthesizer`` does it). The
    noise is ``voc._noise(bound'·hop, seed, ·)``, drawn here and held by the
    artifact, so a row of the artifact equals ``voc.synthesize(feats,
    seed)`` for an utterance whose bound is ``bound'``."""
    hop, fm = voc.cfg.shift_samples, voc.frame_multiple
    out: Dict[int, ExportedProgram] = {}
    with torch.no_grad():
        for bound in bounds:
            b = -(-int(bound) // fm) * fm
            if b in out:
                continue
            graph = _SynthesisGraph(voc, voc._noise(b * hop, seed, voc.device))
            fp = torch.zeros((batch, b, voc.feature_size), dtype=torch.float32, device=voc.device)
            args = (fp, _n_frames_arg(batch, b, voc.device))
            out[b] = torch.export.export(graph, args, strict=False)
    return out


def write_export(
    outdir: str,
    artifacts: Dict[int, ExportedProgram],
    label_dim: int,
    feat_dim: int,
    vocoder_dict: dict,
    batch: int = 1,
    syn_artifacts: Optional[Dict[int, ExportedProgram]] = None,
    hop: Optional[int] = None,
) -> str:
    """Save the programs (``torch.export.save``) and the manifest; returns
    the manifest's path."""
    os.makedirs(outdir, exist_ok=True)
    for bound, ep in artifacts.items():
        torch.export.save(ep, os.path.join(outdir, f"gen_t{bound}.pt2"))
    manifest = {
        "format": "torch.export",
        "package_version": _pkg_version,
        "torch_version": torch.__version__,
        "label_dim": label_dim,
        "feat_dim": feat_dim,
        "bounds": sorted(artifacts),
        "batch": batch,
        "vocoder": vocoder_dict,
    }
    if syn_artifacts:
        for bound, ep in syn_artifacts.items():
            torch.export.save(ep, os.path.join(outdir, f"syn_t{bound}.pt2"))
        manifest["synthesis"] = {"bounds": sorted(syn_artifacts), "hop": hop, "batch": batch}
    mpath = os.path.join(outdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


def _load(path: str, device: torch.device) -> nn.Module:
    """A saved program as a callable module on ``device``: a program
    exported on another device (its user inputs' device) is moved there."""
    ep = torch.export.load(path)
    users = set(ep.graph_signature.user_inputs)
    exported_on = next(n.meta["val"].device.type for n in ep.graph.nodes
                       if n.op == "placeholder" and n.name in users)
    if exported_on != device.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep.module()


def _bound_for(bounds, T: int, what: str) -> int:
    fit = [b for b in bounds if b >= T]
    if not fit:
        raise ValueError(
            f"utterance has {T} frames; largest exported {what}bound is {bounds[-1]} — "
            "re-export with a larger bucket bound")
    return fit[0]


class ExportedGenerator:
    """An export directory's generator artifacts: label→feature inference on
    ``device`` (the card by default) without the model code.

    Pads each utterance to the smallest admitting bound and trims the
    output, the training bucketing contract; raises ``ValueError`` for an
    utterance longer than the largest bound (the producer chose the
    bounds; truncating would corrupt synthesis). The recurrent generators'
    backward direction crosses the zero tail, so features depend on the pad
    length: the artifact's contract is bucket-bound padding, which differs
    from ``eval/serve.py``'s 64-frame multiples by that tail. Needs the
    ``percival::`` operators registered (``percivaltts_tpu_torch.ops``)."""

    def __init__(self, directory: str, device="cuda"):
        with open(os.path.join(directory, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.device = torch.device(device)
        self._fns = {int(b): _load(os.path.join(directory, f"gen_t{b}.pt2"), self.device)
                     for b in self.manifest["bounds"]}

    @property
    def bounds(self) -> list:
        return sorted(self._fns)

    @property
    def batch(self) -> int:
        """Rows per artifact call (1: the latency artifact)."""
        return int(self.manifest.get("batch", 1))

    def _bound_for(self, T: int) -> int:
        return _bound_for(self.bounds, T, "")

    def groups(self, labs) -> list:
        """How :meth:`predict_batch` packs ``labs``: ``[(bound, indices)]``,
        utterances grouped by bound, at most ``batch`` a call, in call
        order."""
        order = sorted(range(len(labs)), key=lambda i: self._bound_for(labs[i].shape[0]))
        out, i = [], 0
        while i < len(order):
            bound = self._bound_for(labs[order[i]].shape[0])
            group = [j for j in order[i : i + self.batch]
                     if self._bound_for(labs[j].shape[0]) == bound]
            out.append((bound, group))
            i += len(group)
        return out

    def _call_rows(self, bound: int, padded: np.ndarray, lens: np.ndarray) -> np.ndarray:
        lab = torch.from_numpy(padded).to(self.device)
        n = _n_frames_arg(1, int(lens[0]), self.device) if self.batch == 1 else \
            torch.from_numpy(np.asarray(lens, np.int32)).to(self.device)
        with torch.inference_mode():
            return self._fns[bound](lab, n).cpu().numpy()

    def __call__(self, lab: np.ndarray) -> np.ndarray:
        """(T, label_dim) raw label frames → (T, feat_dim) features."""
        return self.predict_batch([lab])[0]

    def predict_batch(self, labs) -> list:
        """Raw label matrices → feature matrices, grouped by bucket bound
        and packed ``batch`` rows per artifact call (surplus rows of a group
        are zero-length padding). Output order matches input."""
        out: list = [None] * len(labs)
        for bound, group in self.groups(labs):
            padded = np.zeros((self.batch, bound, labs[group[0]].shape[1]), np.float32)
            lens = np.zeros((self.batch,), np.int32)
            for r, j in enumerate(group):
                padded[r, : labs[j].shape[0]] = labs[j]
                lens[r] = labs[j].shape[0]
            res = self._call_rows(bound, padded, lens)
            for r, j in enumerate(group):
                out[j] = res[r, : labs[j].shape[0]]
        return out


class ExportedSynthesizer:
    """An export directory's synthesis artifacts: features→waveform on
    ``device`` (the card by default), completing the model-code-free chain.

    The whole synthesis (the closed loop included, where the producing
    config ran it) lives in the artifact; the only vocoder code this loader
    runs is the host-side ``export_preprocess`` (WORLD's voicing decision),
    rebuilt from the manifest's vocoder config. Needs the ``percival::``
    operators registered (``percivaltts_tpu_torch.ops``)."""

    def __init__(self, directory: str, device="cuda"):
        with open(os.path.join(directory, "manifest.json")) as f:
            self.manifest = json.load(f)
        syn = self.manifest.get("synthesis")
        if not syn:
            raise ValueError(f"{directory}: manifest has no synthesis artifacts — "
                             "re-export without --no-synth")
        self.hop = int(syn["hop"])
        self.batch = int(syn.get("batch", 1))
        self.device = torch.device(device)
        self._fns = {int(b): _load(os.path.join(directory, f"syn_t{b}.pt2"), self.device)
                     for b in syn["bounds"]}
        from percivaltts_tpu_torch.config import Configuration
        from percivaltts_tpu_torch.vocoders import get_vocoder

        cfg = Configuration.from_dict({"vocoder": self.manifest["vocoder"]})
        self._voc = get_vocoder(cfg.vocoder, device="cpu")  # host-side preprocessing only

    @property
    def bounds(self) -> list:
        return sorted(self._fns)

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        """(T, feature_size) raw (denormalized) features → (T·hop,) f32
        samples."""
        T = feats.shape[0]
        if T == 0:
            return np.zeros((0,), np.float32)
        bound = _bound_for(self.bounds, T, "synthesis ")
        fp = np.zeros((self.batch, bound, feats.shape[1]), np.float32)
        fp[0, :T] = self._voc.export_preprocess(np.asarray(feats, np.float32))
        x = torch.from_numpy(fp).to(self.device)
        lens = np.zeros((self.batch,), np.int32)
        lens[0] = T
        n = _n_frames_arg(1, T, self.device) if self.batch == 1 else \
            torch.from_numpy(lens).to(self.device)
        with torch.inference_mode():
            wav = self._fns[bound](x, n).cpu().numpy()
        return wav[0, : T * self.hop]
