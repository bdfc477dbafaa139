"""Command-line entry points of the port (counterpart of
``percivaltts_tpu/cli.py``): the README's quick start, demo corpus →
compose → train → generate + measures, label files → wavs, the serving
export and the training curves.

Usage:
    python -m percivaltts_tpu_torch.cli demo --out corpus/ [--num 20]
    python -m percivaltts_tpu_torch.cli compose --config corpus/config.json
    python -m percivaltts_tpu_torch.cli train --config corpus/config.json
        [--resume] [--on-device-norm] [--device-corpus] [--preset production]
        [--mesh] [--distributed]
    python -m torch.distributed.run --nproc-per-node N -m percivaltts_tpu_torch.cli train
        --config corpus/config.json --mesh
    python -m percivaltts_tpu_torch.cli generate --config corpus/config.json
        [--checkpoint N | --latest] [--split test|valid] [--no-wav] [--save-features]
    python -m percivaltts_tpu_torch.cli measures --config cfg.json --ref D1 --pred D2
    python -m percivaltts_tpu_torch.cli synth --config cfg.json [--weights W.npz] [--out DIR] labels/*.lab
    python -m percivaltts_tpu_torch.cli export --config cfg.json [--out DIR] [--checkpoint N]
        [--batch B] [--no-synth]
    python -m percivaltts_tpu_torch.cli plot --config cfg.json

``demo`` writes the same corpus and ``config.json`` as the JAX package's
``cli demo``. ``compose`` analyzes the corpus with the configured vocoder
on the card into ``<workdir>/feature_cache`` and writes the normalization
stats (``in_stats.npz`` / ``out_stats.npz``). ``train`` composes first,
then trains the port's ``training.Trainer`` with objective-measure
validation. ``generate`` restores the best checkpoint (``--latest``,
``--checkpoint N``) and writes ``<workdir>/measures.json``, and the
predicted wavs (and ``.cmp`` feature files) under ``<workdir>/generated``.
``measures`` compares two directories of feature files. ``synth`` serves
the best checkpoint's generator (its EMA when the run kept one), or a
flax-path ``.npz`` given with ``--weights``, and writes one ``<uid>.wav``
per label file through the configured vocoder. ``export`` writes the best
(or ``--checkpoint N``) checkpoint's generator and the vocoder's synthesis
as ``torch.export`` artifacts, one per bucket bound, and a manifest under
``<workdir>/export`` (``eval/export.py``: ``ExportedGenerator`` and
``ExportedSynthesizer`` serve them without model or vocoder code).
``plot`` draws ``<workdir>/metrics.jsonl``'s epochs into ``curves.png``.

``train --mesh`` trains data-parallel (``parallel/``): one process per
card, launched by ``torch.distributed.run`` (whose environment
``--distributed`` reads too), each on ``cuda:LOCAL_RANK`` over NCCL, or on
the CPU over gloo when the Python API names the CPU. Every rank composes;
rank 0 alone writes the feature cache and the stats. The two flags differ
only in what the ranks stand for (``Mesh.per_process``): under ``--mesh``
the devices of one JAX process, under ``--distributed`` the processes of a
multi-process JAX run. That matters to a corpus on the device with
``shard_corpus``: ``--mesh`` uploads rank ``r``'s block of the padded
corpus; ``--distributed`` lays out each rank's own data as the JAX
package's processes do (``data/device_corpus.py``). As in the JAX
package's ``cli train --distributed``, every rank passes the whole corpus
it composed, with no ``Dataset.shard``, so each rank's block is the whole
corpus. A Python caller whose ranks each hold their own
``Dataset.shard(world, rank)`` builds ``make_mesh(per_process=True)`` and
the ``Trainer`` itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

import torch

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.utils.logging import print_log


def cmd_demo(args, device) -> int:
    """The synthetic demo corpus, and a ``config.json`` sized for it (small
    model, few epochs, f32) beside it."""
    from percivaltts_tpu_torch.data.demo import generate_demo_corpus

    generate_demo_corpus(
        args.out,
        num_utterances=args.num,
        seed=args.seed,
        hard=args.hard,
        jitter=args.jitter,
        speaker_f0=args.speaker_f0,
        encode_f0=args.encode_f0,
        noise_snr_db=args.noise_snr_db,
        reverb_ms=args.reverb_ms,
    )
    cfg = Configuration(workdir=os.path.join(args.out, "exp"))
    d = cfg.to_dict()
    d["data"].update(
        corpus_dir=args.out,
        fileids=os.path.join(args.out, "fileids.scp"),
        question_file=os.path.join(args.out, "questions.hed"),
        batch_size=4,
        bucket_bounds=[256],
        num_valid=max(args.num // 8, 1),
        num_test=max(args.num // 8, 1),
    )
    d["vocoder"].update(spec_size=33, nm_size=17)
    d["model"].update(generator="cnn", hidden_size=64, cnn_blocks=2,
                      critic_hidden=64, compute_dtype="float32")
    d["train"].update(trainer="lse", epochs=30, lr_gen=2e-3, patience=10,
                      checkpoint_every=5)
    cfg_path = os.path.join(args.out, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)
    print_log(f"wrote {cfg_path}")
    return 0


def _compose(cfg: Configuration, device, normalize: bool = True, mesh=None):
    """Compose the corpus through the workdir's feature cache and save its
    stats. Under a mesh every rank composes, as the JAX package's processes
    do, and rank 0 alone writes the cache and the stats; the others read
    what rank 0 has finished, so no rank waits on another."""
    from percivaltts_tpu_torch.data.compose import compose

    writer = mesh is None or mesh.rank == 0
    cache = os.path.join(cfg.workdir, "feature_cache")
    os.makedirs(cache, exist_ok=True)
    corpus = compose(cfg, cache_dir=cache, normalize=normalize, device=device,
                     write_cache=writer)
    if writer:
        corpus.save_stats(cfg.workdir)
    return corpus


def cmd_compose(args, device) -> int:
    corpus = _compose(Configuration.load(args.config), device)
    print_log(
        f"train/valid/test: {len(corpus.train)}/{len(corpus.valid)}/"
        f"{len(corpus.test)} utterances, label_dim={corpus.train.label_dim}, "
        f"feat_dim={corpus.train.feat_dim}"
    )
    return 0


def apply_preset(cfg: Configuration, name: str) -> Configuration:
    """Overlay the JAX package's measured-best settings on a config: an EMA
    of the generator weights (0.995), the corpus resident on the device,
    the GV-aware best checkpoint for WGAN runs with measures, and the
    prediction-side voicing rules: for the PML vocoder the lowest 65% of
    nm bands < 0.60, for WORLD the bap rule (``vuv_rule="bap"``)."""
    if name != "production":
        raise ValueError(f"unknown preset: {name!r}")
    tr = dict(ema_decay=0.995, device_corpus=True)
    if cfg.train.trainer == "wgan" and cfg.train.measures_every > 0:
        tr["best_metric"] = "mcd_gv"
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    if cfg.vocoder.kind == "world" and cfg.vocoder.vuv_rule == "stream":
        cfg = cfg.replace(vocoder=dataclasses.replace(cfg.vocoder, vuv_rule="bap"))
        tr["vocoder.vuv_rule"] = "bap"
    if cfg.vocoder.kind == "pml" and cfg.vocoder.vuv_pred_threshold is None:
        cfg = cfg.replace(vocoder=dataclasses.replace(
            cfg.vocoder, vuv_pred_low_frac=0.65, vuv_pred_threshold=0.60))
        tr["vocoder.vuv_pred"] = "0.65/0.60"
    print_log(f"preset {name!r}: {tr}")
    return cfg


def cmd_train(args, device) -> int:
    """Compose (through the feature cache), save the stats, train; with
    ``--mesh`` / ``--distributed`` data-parallel over the process group it
    joins (and leaves at the end, when it made the group)."""
    import torch.distributed as dist

    made_group = (args.mesh or args.distributed) and not dist.is_initialized()
    try:
        return _train(args, device)
    finally:
        if made_group and dist.is_initialized():
            dist.destroy_process_group()


def _train_mesh(args, cfg: Configuration, device):
    """The mesh ``train`` trains over: None without ``--mesh`` /
    ``--distributed``; else every rank of the process group it joins, its
    ranks standing for a multi-process JAX run's processes under
    ``--distributed`` and for one JAX process's devices under ``--mesh``."""
    if not (args.mesh or args.distributed):
        return None
    from percivaltts_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(backend="nccl" if device.type == "cuda" else "gloo")
    print_log(f"process group: {distributed.process_info()}")
    world = distributed.process_info()["process_count"]
    mesh = make_mesh(data_parallel=cfg.train.data_parallel, devices=[device] * world,
                     per_process=args.distributed)
    print_log(f"training on mesh {mesh.shape} (rank {mesh.rank}, {mesh.device}, "
              f"{'per-process' if mesh.per_process else 'one-host'} layout)")
    return mesh


def _train(args, device) -> int:
    from percivaltts_tpu_torch.training import Trainer

    cfg = Configuration.load(args.config)
    if args.preset:
        cfg = apply_preset(cfg, args.preset)
    if args.device_corpus:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_corpus=True))
    mesh = _train_mesh(args, cfg, device)
    if mesh is not None:
        device = mesh.device
    on_device = args.on_device_norm
    corpus = _compose(cfg, device, normalize=not on_device, mesh=mesh)
    if on_device and cfg.train.measures_every > 0:
        print_log(
            "WARNING: --on-device-norm disables objective-measure "
            "validation (measures_every): the measures need host-normalized "
            "features"
        )
    trainer = Trainer(
        cfg,
        corpus.train,
        corpus.valid,
        in_stats=corpus.in_stats if on_device else None,
        out_stats=corpus.out_stats if on_device else None,
        measures_stats=None if on_device else corpus.out_stats,
        mesh=mesh,
        device=device,
    )
    if args.resume:
        trainer.resume()
    trainer.train()
    trainer.close()
    return 0


def cmd_generate(args, device) -> int:
    """Generation and objective measures from a checkpoint."""
    from percivaltts_tpu_torch.eval.generate import generate
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import make_gan_state

    cfg = Configuration.load(args.config)
    corpus = _compose(cfg, device)
    ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    step = args.checkpoint
    if step is None:
        step = ckpt.latest_step() if args.latest else ckpt.best_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt.directory} (train one first)")
    print_log(f"generating from checkpoint step {step}")
    state = ckpt.restore(make_gan_state(cfg, corpus.train.label_dim, device=device), step)
    measures = generate(
        cfg,
        state,
        corpus.test if args.split == "test" else corpus.valid,
        corpus.out_stats,
        synthesize=not args.no_wav,
        save_features=args.save_features,
    )
    with open(os.path.join(cfg.workdir, "measures.json"), "w") as f:
        json.dump(measures, f, indent=2)
    return 0


def cmd_measures(args, device) -> int:
    """Objective measures between two directories of per-utterance feature
    files (headerless float32), printed as JSON: mean MCD, F0 RMSE and VUV
    error over the files the two share."""
    import numpy as np

    from percivaltts_tpu_torch.eval.measures import f0_rmse, mcd, vuv_error
    from percivaltts_tpu_torch.utils.fileio import load_binary_file
    from percivaltts_tpu_torch.vocoders import get_vocoder

    voc = get_vocoder(Configuration.load(args.config).vocoder, device)
    dim = voc.feature_size
    ref_files = {os.path.basename(p): p for p in glob.glob(os.path.join(args.ref, "*" + args.ext))}
    if not ref_files:
        raise FileNotFoundError(f"no {args.ext} files in {args.ref}")
    mcds, f0s, vuvs, matched = [], [], [], 0
    for name, rp in sorted(ref_files.items()):
        pp = os.path.join(args.pred, name)
        if not os.path.exists(pp):
            continue
        matched += 1
        ref = load_binary_file(rp, dim)
        pred = load_binary_file(pp, dim)
        n = min(len(ref), len(pred))
        mcds.append(float(mcd(voc.cepstra(pred[:n]), voc.cepstra(ref[:n]))))
        try:
            f0p, vp = voc.f0_vuv_pred(pred[:n])
            f0r, vr = voc.f0_vuv(ref[:n])
        except NotImplementedError:
            continue
        f0s.append(float(f0_rmse(f0p, f0r, vp, vr)))
        vuvs.append(float(vuv_error(vp, vr)))
    if not matched:
        raise FileNotFoundError(f"no files in {args.pred} match the names in {args.ref}")
    out = {"files": matched, "mcd_db": float(np.mean(mcds))}
    if f0s:
        out["f0_rmse_hz"] = float(np.mean(f0s))
        out["vuv_error_pct"] = float(np.mean(vuvs))
    print(json.dumps(out, indent=2))
    return 0


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


def cmd_export(args, device) -> int:
    """The best (or ``--checkpoint N``) checkpoint's generator, its EMA
    weights when the run kept them, as label→features artifacts, and
    unless ``--no-synth`` the configured vocoder's default synthesis as
    features→waveform artifacts, one per bucket bound, exported on
    ``device`` (``eval/export.py``)."""
    from percivaltts_tpu_torch.data.normalize import NormStats
    from percivaltts_tpu_torch.eval.export import export_generator, export_synthesis, write_export
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import eval_generator, make_gan_state
    from percivaltts_tpu_torch.vocoders import get_vocoder

    cfg = Configuration.load(args.config)
    in_stats = NormStats.load(os.path.join(cfg.workdir, "in_stats.npz"))
    out_stats = NormStats.load(os.path.join(cfg.workdir, "out_stats.npz"))
    label_dim = int(in_stats.shift.shape[0])
    ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"))
    step = args.checkpoint if args.checkpoint is not None else ckpt.best_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt.directory} to export (train one first)")
    state = ckpt.restore(make_gan_state(cfg, label_dim, device=device), step)
    kind = "EMA" if state.ema is not None else "live"
    print_log(f"exporting on {device} from checkpoint step {step} ({kind} generator weights)")
    bounds = cfg.data.bucket_bounds
    t0 = time.perf_counter()
    artifacts = export_generator(eval_generator(state), in_stats, out_stats, label_dim, bounds,
                                 batch=args.batch)
    syn = None
    if not args.no_synth:
        syn = export_synthesis(get_vocoder(cfg.vocoder, device), bounds, batch=args.batch)
        print_log(f"exported the synthesis ({cfg.vocoder.kind}, closed_loop="
                  f"{cfg.vocoder.closed_loop}) at bounds {sorted(syn)}")
    outdir = args.out or os.path.join(cfg.workdir, "export")
    mpath = write_export(outdir, artifacts, label_dim, int(out_stats.shift.shape[0]),
                         dataclasses.asdict(cfg.vocoder), batch=args.batch, syn_artifacts=syn,
                         hop=cfg.vocoder.shift_samples)
    sizes = {name: os.path.getsize(os.path.join(outdir, name))
             for name in sorted(os.listdir(outdir)) if name.endswith(".pt2")}
    print_log(f"wrote {len(sizes)} artifacts to {outdir} in {time.perf_counter() - t0:.1f} s "
              f"(bytes: {sizes}); manifest {mpath}")
    return 0


def cmd_plot(args, device) -> int:
    """``<workdir>/metrics.jsonl``'s epoch records → ``curves.png``."""
    from percivaltts_tpu_torch.utils.curves import plot_curves

    cfg = Configuration.load(args.config)
    print_log(f"wrote {plot_curves(os.path.join(cfg.workdir, 'metrics.jsonl'))}")
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="percivaltts-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("demo", help="generate the synthetic demo corpus")
    pd.add_argument("--out", required=True)
    pd.add_argument("--num", type=int, default=20)
    pd.add_argument("--seed", type=int, default=1234)
    pd.add_argument("--hard", action="store_true",
                    help="stress corpus: plosive bursts, silence clicks, wide f0, "
                    "amplitude dynamics")
    pd.add_argument("--jitter", type=float, default=0.0,
                    help="per-phone-instance formant jitter (e.g. 0.12 = ±12%%)")
    pd.add_argument("--speaker-f0", type=float, default=0.0, dest="speaker_f0",
                    help="pin every utterance's base f0 (Hz)")
    pd.add_argument("--encode-f0", action="store_true", dest="encode_f0",
                    help="write each utterance's base f0 into the labels")
    pd.add_argument("--noise-snr-db", type=float, default=0.0, dest="noise_snr_db",
                    help="additive background noise at this SNR (dB)")
    pd.add_argument("--reverb-ms", type=float, default=0.0, dest="reverb_ms",
                    help="synthetic room reverb tail of this length")
    pd.set_defaults(fn=cmd_demo)

    pc = sub.add_parser("compose", help="compose corpus features + stats")
    pc.add_argument("--config", required=True)
    pc.set_defaults(fn=cmd_compose)

    pt = sub.add_parser("train", help="train (composes first)")
    pt.add_argument("--config", required=True)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--mesh", action="store_true",
                    help="data parallelism over the ranks torch.distributed.run launched "
                    "(one process per card; alone: a group of one)")
    pt.add_argument("--distributed", action="store_true",
                    help="multi-process (multi-host) training; implies --mesh, its ranks "
                    "standing for the JAX package's processes: with shard_corpus each rank "
                    "lays out the corpus it composed (the whole corpus, as the JAX CLI "
                    "passes it) as its own block")
    pt.add_argument("--on-device-norm", action="store_true", dest="on_device_norm",
                    help="normalize on the device inside the step (raw features ship)")
    pt.add_argument("--device-corpus", action="store_true", dest="device_corpus",
                    help="keep the padded training corpus on the device and gather "
                    "batches there")
    pt.add_argument("--preset", choices=("production",), default=None,
                    help="overlay the measured-best settings (EMA 0.995, the corpus on "
                    "the device, GV-aware best checkpoint for WGAN runs with measures)")
    pt.set_defaults(fn=cmd_train)

    pg = sub.add_parser("generate", help="generate features/wavs + measures")
    pg.add_argument("--config", required=True)
    pg.add_argument("--checkpoint", type=int, default=None)
    pg.add_argument("--latest", action="store_true",
                    help="the latest checkpoint instead of the best")
    pg.add_argument("--split", choices=("test", "valid"), default="test")
    pg.add_argument("--no-wav", action="store_true")
    pg.add_argument("--save-features", action="store_true")
    pg.set_defaults(fn=cmd_generate)

    pm = sub.add_parser("measures", help="objective measures between two feature-file directories")
    pm.add_argument("--config", required=True)
    pm.add_argument("--ref", required=True, help="reference feature dir")
    pm.add_argument("--pred", required=True, help="predicted feature dir")
    pm.add_argument("--ext", default=".cmp", help="feature file extension")
    pm.set_defaults(fn=cmd_measures)

    ps = sub.add_parser("synth", help="label files → wavs (pure inference)")
    ps.add_argument("--config", required=True)
    ps.add_argument("--weights", default=None,
                    help="a flax-path .npz to serve instead of the best checkpoint")
    ps.add_argument("--out", default=None)
    ps.add_argument("labels", nargs="+", help="label file paths or globs")
    ps.set_defaults(fn=cmd_synth)

    px = sub.add_parser("export", help="export the generator and the synthesis as "
                        "torch.export serving artifacts")
    px.add_argument("--config", required=True)
    px.add_argument("--out", default=None, help="output dir (default <workdir>/export)")
    px.add_argument("--checkpoint", type=int, default=None)
    px.add_argument("--batch", type=int, default=1,
                    help="rows per artifact call (1 = latency serving; >1 = throughput "
                    "serving, utterances packed batch rows a call)")
    px.add_argument("--no-synth", action="store_true", dest="no_synth",
                    help="skip the synthesis (features→waveform) artifacts")
    px.set_defaults(fn=cmd_export)

    pp = sub.add_parser("plot", help="plot training curves from metrics.jsonl")
    pp.add_argument("--config", required=True)
    pp.set_defaults(fn=cmd_plot)
    return p


def main(argv=None, device="cuda") -> int:
    """``device``: where the vocoder, the generator and training run. The
    command line runs on the card; the Python API lets a caller name
    another device explicitly."""
    args = _parser().parse_args(argv)
    return args.fn(args, torch.device(device))


if __name__ == "__main__":
    sys.exit(main())
