"""Command-line entry point of the port (counterpart of ``percivaltts_tpu/cli.py``).

Ported so far: ``synth``. It reads the config, the workdir's normalization
stats (``in_stats.npz`` / ``out_stats.npz``), the generator weights
``<workdir>/generator.npz`` (a flat flax-path ``.npz``, written on a host that
has jax with ``percivaltts_tpu_torch.weights.save_npz``) and HTS label files,
and writes one ``<uid>.wav`` per label file: the generator's denormalized
features through the configured vocoder (the default PML vocoder, closed
loop), as the JAX package's ``cli synth`` does.

Usage:
    python -m percivaltts_tpu_torch.cli synth --config cfg.json [--out DIR] labels/*.lab
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.utils.logging import print_log

WEIGHTS_FILE = "generator.npz"


def cmd_synth(args, device) -> int:
    """HTS label file(s) → synthesized wavs, no acoustic targets needed."""
    from percivaltts_tpu_torch import weights
    from percivaltts_tpu_torch.data.compose import save_wav
    from percivaltts_tpu_torch.data.hts_labels import QuestionSet, binarize_label_file
    from percivaltts_tpu_torch.data.normalize import NormStats
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.models.generators import build_generator
    from percivaltts_tpu_torch.vocoders import get_vocoder

    cfg = Configuration.load(args.config)
    in_stats = NormStats.load(os.path.join(cfg.workdir, "in_stats.npz"))
    out_stats = NormStats.load(os.path.join(cfg.workdir, "out_stats.npz"))
    questions = QuestionSet.from_hed(cfg.data.question_file)
    voc = get_vocoder(cfg.vocoder, device)

    label_dim = int(in_stats.shift.shape[0])
    gen = build_generator(cfg.model, cfg.vocoder, label_dim)
    wpath = os.path.join(cfg.workdir, WEIGHTS_FILE)
    weights.load_flax_params(gen, weights.load_npz(wpath))
    gen.to(device).eval()
    print_log(f"synthesizing on {device} with weights {wpath}")

    outdir = args.out or os.path.join(cfg.workdir, "synth")
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for pattern in args.labels:
        paths.extend(sorted(glob.glob(pattern)))
    if not paths:
        raise FileNotFoundError(f"no label files match {args.labels}")
    shift_sec = cfg.vocoder.shift_ms / 1000.0
    labs = [binarize_label_file(p, questions, shift_sec) for p in paths]
    wavs = voc.synthesize_batch(serve(gen, labs, in_stats, out_stats))
    for p, wav in zip(paths, wavs):
        uid = os.path.splitext(os.path.basename(p))[0]
        out_path = os.path.join(outdir, uid + ".wav")
        save_wav(out_path, cfg.vocoder.fs, wav)
        print_log(f"{p} → {out_path} ({len(wav) / cfg.vocoder.fs:.2f} s)")
    return 0


def main(argv=None, device="cuda") -> int:
    """``device``: where the generator and the vocoder run. The command line
    runs on the card; the Python API lets a caller name another device
    explicitly."""
    p = argparse.ArgumentParser(prog="percivaltts-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("synth", help="label files → wavs (pure inference)")
    ps.add_argument("--config", required=True)
    ps.add_argument("--out", default=None)
    ps.add_argument("labels", nargs="+", help="label file paths or globs")
    ps.set_defaults(fn=cmd_synth)
    args = p.parse_args(argv)
    return args.fn(args, torch.device(device))


if __name__ == "__main__":
    sys.exit(main())
