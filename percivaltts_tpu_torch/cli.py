"""Command-line entry point of the port (counterpart of ``percivaltts_tpu/cli.py``).

Ported so far: ``synth``. It reads the config, the workdir's normalization
stats (``in_stats.npz`` / ``out_stats.npz``) and HTS label files, and writes
one ``<uid>.wav`` per label file: the generator's denormalized features
through the configured vocoder (the default PML vocoder, closed loop), as
the JAX package's ``cli synth`` does. The generator is, as there, the best
checkpoint's under ``<workdir>/checkpoints`` (written by the port's
``training.Trainer``) with its ``eval_params``: the EMA copy when the run
carries one. ``--weights FILE.npz`` serves a flat flax-path ``.npz``
instead (weights exported from a JAX run with
``percivaltts_tpu_torch.weights.save_npz`` on a host that has jax).

Usage:
    python -m percivaltts_tpu_torch.cli synth --config cfg.json [--weights W.npz] [--out DIR] labels/*.lab
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.utils.logging import print_log


def _generator(args, cfg, label_dim: int, device):
    """The generator to serve, in eval mode on ``device``: ``--weights``'
    flax-path ``.npz``, else the best checkpoint's ``eval_params``."""
    if args.weights:
        from percivaltts_tpu_torch import weights
        from percivaltts_tpu_torch.models.generators import build_generator

        gen = build_generator(cfg.model, cfg.vocoder, label_dim)
        weights.load_flax_params(gen, weights.load_npz(args.weights))
        print_log(f"synthesizing on {device} with the weights in {args.weights}")
        return gen.to(device).eval()
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import eval_generator, make_gan_state

    ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    step = ckpt.best_step()
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint under {ckpt.directory} to serve (train one, or pass --weights)")
    state = ckpt.restore(make_gan_state(cfg, label_dim, device=device), step)
    kind = "EMA" if state.ema is not None else "live"
    print_log(f"synthesizing on {device} from checkpoint step {step} ({kind} generator weights)")
    return eval_generator(state)


def cmd_synth(args, device) -> int:
    """HTS label file(s) → synthesized wavs, no acoustic targets needed."""
    from percivaltts_tpu_torch.data.compose import save_wav
    from percivaltts_tpu_torch.data.hts_labels import QuestionSet, binarize_label_file
    from percivaltts_tpu_torch.data.normalize import NormStats
    from percivaltts_tpu_torch.eval.serve import serve
    from percivaltts_tpu_torch.vocoders import get_vocoder

    cfg = Configuration.load(args.config)
    in_stats = NormStats.load(os.path.join(cfg.workdir, "in_stats.npz"))
    out_stats = NormStats.load(os.path.join(cfg.workdir, "out_stats.npz"))
    questions = QuestionSet.from_hed(cfg.data.question_file)
    voc = get_vocoder(cfg.vocoder, device)

    gen = _generator(args, cfg, int(in_stats.shift.shape[0]), device)

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
    ps.add_argument("--weights", default=None,
                    help="a flax-path .npz to serve instead of the best checkpoint")
    ps.add_argument("--out", default=None)
    ps.add_argument("labels", nargs="+", help="label file paths or globs")
    ps.set_defaults(fn=cmd_synth)
    args = p.parse_args(argv)
    return args.fn(args, torch.device(device))


if __name__ == "__main__":
    sys.exit(main())
