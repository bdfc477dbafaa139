"""Training loop: epochs, validation, early stopping, checkpointing
(counterpart of ``percivaltts_tpu/training/loop.py``).

Reference parity: the epoch loops of ``percivaltts/optimizertts.py`` and
``optimizertts_wgan.py`` — shuffled batches each epoch, per-epoch
validation cost, early stopping on best validation with patience,
save-best checkpointing, resume ("cont").

Notes for the card:
* The WGAN outer step consumes ``n_critic + 1`` same-shape batches (one per
  critic update + one for the generator), stacked on the host.
* A background thread (``utils/prefetch.py``) assembles each batch, casts
  it to the transfer dtype and pins it; the main thread copies it to the
  card with ``non_blocking=True`` and dispatches the step, so batch
  assembly overlaps the card's work.
* With ``TrainConfig.device_corpus`` the padded training corpus lives on
  the card (``data/device_corpus.py``) and each step ships one pinned
  int32 index array; the batch is gathered on the card.
* The steps' 0-d metric tensors stay on the card until the epoch ends and
  are read back in one copy; validation reads back once as well. A read
  per step would stall the host on every step.
* Every ``measures_every`` epochs the objective measures (MCD, F0 RMSE,
  VUV, GV and modulation-spectrum ratios) run over the validation split
  through the generation path; ``best_metric`` ``"mcd"`` / ``"mcd_gv"``
  select the best checkpoint and drive early stopping on them.
* Under a data-parallel mesh (``parallel/``) every rank iterates the same
  global batches and the prefetch thread keeps only the rank's rows, so
  only those are cast, pinned and copied. The steps' metrics come out
  global (they ride in the gradient all-reduce), validation sums once over
  the ranks, and every rank runs the measures and takes rank 0's scores:
  every rank takes the same best-checkpoint and early-stopping decisions.
  Rank 0 alone writes ``config.json``, ``metrics.jsonl``, the trace and
  the checkpoints.
* On a mesh whose ranks stand for processes (``Mesh.per_process``) a
  ``shard_corpus`` device corpus takes each rank's ``train_ds`` as its own
  data (``data/device_corpus.py``). Nothing here reads a global count:
  an epoch's steps and frames come from the corpus's padded block, as the
  JAX trainer counts them, and the sanity record is rank 0's own data's,
  as the JAX package's process 0 records its own.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from percivaltts_tpu_torch.config import Configuration
from percivaltts_tpu_torch.data.dataset import Dataset, cost_0pred_rmse
from percivaltts_tpu_torch.data.device_corpus import (
    DeviceCorpus,
    make_device_lse_step,
    make_device_wgan_step,
)
from percivaltts_tpu_torch.parallel.mesh import global_sum, local_rows
from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
from percivaltts_tpu_torch.training.losses import stream_weight_vector
from percivaltts_tpu_torch.training.lse import lse_eval_sums, lse_step
from percivaltts_tpu_torch.training.ondevice import make_normalizing_step
from percivaltts_tpu_torch.training.state import GANState, make_gan_state
from percivaltts_tpu_torch.training.wgan import make_wgan_step
from percivaltts_tpu_torch.utils.logging import MetricsLogger, print_log
from percivaltts_tpu_torch.utils.prefetch import prefetch
from percivaltts_tpu_torch.utils.profiling import StepTimer, system_info, trace

# the batch keys the steps read (``lengths`` stays on the host)
STEP_KEYS = ("lab", "cmp", "mask")
TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def _group_wgan_batches(
    batches: Iterator[Dict[str, np.ndarray]],
    group: int,
    buffers: Dict[int, List[Dict[str, np.ndarray]]],
) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Group same-shape batches into (stacked critic batches, gen batch).

    ``buffers`` persists across epochs (the trainer owns it): a partial
    group at epoch end waits for the next epoch's batches of the same
    bucket bound, so every batch in a group is distinct. A run whose corpus
    never fills a whole group performs zero WGAN steps; callers warn on
    zero-step epochs. The buffers are not checkpointed: a resumed run
    starts with none, as the JAX trainer does.
    """
    for b in batches:
        bound = b["lab"].shape[1]
        buf = buffers.setdefault(bound, [])
        buf.append(b)
        if len(buf) == group:
            critic = {
                k: np.stack([x[k] for x in buf[:-1]]) for k in buf[0]
            }
            yield critic, buf[-1]
            buffers[bound] = []


class _EpochProfiler:
    """Per-epoch step instrumentation: a ``torch.profiler`` trace around the
    first ``TrainConfig.profile_steps`` steps of the profiling epoch, plus
    per-step dispatch timing that flows into the epoch's metrics record."""

    def __init__(self, workdir: str, profile_steps: int, active: bool, device: torch.device):
        self.timer = StepTimer()
        self.device = device
        self.remaining = profile_steps if (active and profile_steps > 0) else 0
        self._ctx = None
        if self.remaining:
            self._ctx = trace(workdir, cuda=device.type == "cuda")
            self._ctx.__enter__()

    def step(self, fn, *args):
        self.timer.start()
        out = fn(*args)
        self.timer.stop()
        if self.remaining:
            self.remaining -= 1
            if self.remaining == 0:
                # the traced steps must have run before the trace closes
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._close()
        return out

    def _close(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None

    def summary(self) -> Dict[str, float]:
        self._close()
        t = self.timer
        return {"step_mean_s": t.mean, "step_max_s": t.max}


class Trainer:
    """End-to-end trainer for both the LSE and WGAN-GP objectives."""

    def __init__(
        self,
        cfg: Configuration,
        train_ds: Dataset,
        valid_ds: Optional[Dataset] = None,
        mesh=None,
        workdir: Optional[str] = None,
        in_stats=None,
        out_stats=None,
        measures_stats=None,
        device=None,
    ):
        """``in_stats``/``out_stats``: pass NormStats (with *raw* datasets)
        to normalize on the device inside the step instead of on the host
        (``training/ondevice.py``).

        ``measures_stats``: the output-stream NormStats of a *normalized*
        pipeline, which turns on objective-measure validation
        (``TrainConfig.measures_every``) and the measure-driven best
        checkpoint (``best_metric`` ``"mcd"`` / ``"mcd_gv"``).

        ``mesh`` (``parallel.make_mesh``): train data-parallel, this rank on
        its rows of every batch; ``batch_size`` is the global batch and
        must split evenly over the ranks.

        ``device``: where the state lives and the steps run; the mesh's
        device under a mesh, else the card unless the caller names another
        (the CPU runs the kernels' plain twins). ``TrainConfig.debug_nans``
        turns on ``torch.autograd.set_detect_anomaly``, for the whole
        process."""
        train = cfg.train
        if mesh is not None:
            dp = mesh.shape["data"]
            if cfg.data.batch_size % dp != 0:
                raise ValueError(
                    f"batch_size {cfg.data.batch_size} must be divisible by "
                    f"the mesh data axis ({dp} devices) for data parallelism"
                )
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        if train.best_metric in ("mcd", "mcd_gv") and (
            train.measures_every <= 0 or measures_stats is None
        ):
            raise ValueError(
                f"best_metric={train.best_metric!r} needs "
                "measures_every > 0 and measures_stats"
            )
        self.cfg = cfg
        self.train_ds = train_ds
        self.valid_ds = valid_ds
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device or "cuda")
        # rank 0 writes the run's records; every rank computes them
        self.writer = mesh is None or mesh.rank == 0
        self.workdir = workdir or cfg.workdir
        os.makedirs(self.workdir, exist_ok=True)
        if self.writer:
            cfg.dump(os.path.join(self.workdir, "config.json"))
        self.metrics = MetricsLogger(os.path.join(self.workdir, "metrics.jsonl"),
                                     enabled=self.writer)
        self.metrics.log("system", **system_info(self.device))
        # sanity scale for the losses (reference: data.py's zero-predictor
        # RMSE): a trained model must beat this by a wide margin
        zero_rmse = cost_0pred_rmse(train_ds.cmps)
        self.metrics.log("sanity", cost_0pred_rmse=zero_rmse)
        print_log(f"zero-predictor RMSE over targets: {zero_rmse:.5f}")
        self.ckpt = CheckpointManager(
            os.path.join(self.workdir, "checkpoints"), keep=train.keep_checkpoints, mesh=mesh
        )

        if train.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        self.state: GANState = make_gan_state(cfg, train_ds.label_dim, device=self.device,
                                              mesh=mesh)
        self.measures_stats = measures_stats
        self.dcorpus = None
        if train.device_corpus:
            self.dcorpus = DeviceCorpus(
                train_ds,
                bound=max(cfg.data.bucket_bounds),
                dtype="bfloat16" if train.transfer_dtype == "bfloat16" else "float32",
                mesh=mesh,
                shard_corpus=train.shard_corpus,
                device=self.device,
            )

        def _maybe_norm(fn):
            if in_stats is None:
                return fn
            return make_normalizing_step(fn, in_stats, out_stats, self.device)

        dim_w = stream_weight_vector(
            cfg.vocoder.streams, train.stream_weights, cfg.vocoder.feature_size
        )
        if train.trainer == "wgan":
            self._wgan_step = _maybe_norm(make_wgan_step(train, dim_w, mesh))
            if self.dcorpus is not None:
                self._wgan_step = make_device_wgan_step(self._wgan_step, train.n_critic)
        else:
            self._lse_step = _maybe_norm(
                functools.partial(
                    lse_step,
                    dim_weights=dim_w,
                    ema_decay=train.ema_decay,
                    boundary_weight=train.boundary_weight,
                    boundary_radius=train.boundary_radius,
                    mesh=mesh,
                )
            )
            if self.dcorpus is not None:
                self._lse_step = make_device_lse_step(self._lse_step)
        self._eval_step = _maybe_norm(lse_eval_sums)

        self.best_valid = float("inf")
        self.best_epoch = -1
        self._stale_evals = 0  # metric evaluations since the last improvement
        # the epoch to profile; set per train() call relative to the first
        # epoch THIS process runs (a fixed value would never fire on resumed
        # runs)
        self._profile_epoch = -1
        # partial WGAN groups carried across epochs (see _group_wgan_batches)
        self._wgan_buffers: Dict[int, List[Dict[str, np.ndarray]]] = {}

    # ------------------------------------------------------------------ #

    def resume(self) -> bool:
        """Reload the latest checkpoint if one exists (the reference's
        ``cont`` flag). Returns True when resumed."""
        step = self.ckpt.latest_step()
        if step is None:
            return False
        self.ckpt.restore(self.state, step)
        # re-seed best-metric tracking from the retained checkpoints so the
        # first resumed epoch isn't treated as an improvement and the
        # early-stopping patience window continues instead of restarting
        best = self.ckpt.best_score()
        if best is not None:
            self.best_epoch, self.best_valid = best
        print_log(
            f"resumed from checkpoint at epoch {step}"
            + (f" (best {self.best_valid:.5f} @ {self.best_epoch})" if best else "")
        )
        return True

    def _cast(self, batch: Dict[str, np.ndarray], axis: int = 0) -> Dict[str, torch.Tensor]:
        """Host tensors of the step's keys: this rank's rows (along
        ``axis``) under a mesh, ``lab``/``cmp`` in the transfer dtype
        (``TrainConfig.transfer_dtype``; bf16 halves the bytes copied, and
        the models compute in bf16 regardless), pinned when the state is
        on the card. The mask stays f32: its sums are loss denominators,
        and a bf16 sum over thousands of frames is not exact."""
        dt = TRANSFER_DTYPES[self.cfg.train.transfer_dtype]
        out = {}
        for k in STEP_KEYS:
            v = batch[k] if self.mesh is None else local_rows(batch[k], self.mesh, axis)
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k != "mask":
                t = t.to(dt)
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _put(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def _readback(self, metrics_log: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        """Sum of each metric over the steps, read back in one copy; it
        waits for the dispatched steps. Under a mesh the steps' metrics are
        global already (they ride in the gradient all-reduce)."""
        agg: Dict[str, float] = {}
        if metrics_log:
            keys = list(metrics_log[0])
            flat = torch.stack([m[k].float() for m in metrics_log for k in keys]).cpu().tolist()
            for i, v in enumerate(flat):
                agg[keys[i % len(keys)]] = agg.get(keys[i % len(keys)], 0.0) + v
        return agg

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        d = self.cfg.data
        if self.dcorpus is not None:
            return self._train_epoch_device(epoch, t0)
        batches = self.train_ds.batches(
            d.batch_size, d.bucket_bounds, shuffle=True, seed=d.shuffle_seed, epoch=epoch
        )
        prof = _EpochProfiler(
            self.workdir,
            self.cfg.train.profile_steps,
            active=epoch == self._profile_epoch and self.writer,
            device=self.device,
        )
        nsteps = 0
        frames = 0.0
        metrics_log = []
        if self.cfg.train.trainer == "wgan":
            group = self.cfg.train.n_critic + 1

            def prepared():
                # batch assembly, cast and pinning run in the prefetch
                # thread, overlapping the card's work
                for critic_b, gen_b in _group_wgan_batches(
                    batches, group, self._wgan_buffers
                ):
                    nf = float(critic_b["mask"].sum() + gen_b["mask"].sum())
                    yield self._cast(critic_b, axis=1), self._cast(gen_b), nf

            for cb, gb, nf in prefetch(prepared()):
                cb, gb = self._put(cb), self._put(gb)
                self.state, m = prof.step(self._wgan_step, self.state, cb, gb)
                nsteps += 1
                frames += nf
                metrics_log.append(m)
        else:

            def prepared():
                for b in batches:
                    yield self._cast(b), float(b["mask"].sum())

            for gb, nf in prefetch(prepared()):
                gb = self._put(gb)
                self.state, m = prof.step(self._lse_step, self.state, gb)
                nsteps += 1
                frames += nf
                metrics_log.append(m)
        # one readback for the epoch; it waits for the dispatched steps, so
        # dt is honest
        agg = self._readback(metrics_log)
        dt = time.time() - t0
        if nsteps == 0 and self.cfg.train.trainer == "wgan":
            print_log(
                "WGAN epoch performed 0 steps: the corpus yields fewer than "
                f"n_critic+1={self.cfg.train.n_critic + 1} same-bucket batches "
                "per epoch; partial groups carry over to the next epoch "
                "(lower batch_size or bucket_bounds to fill groups faster)"
            )
        out = {k: v / max(nsteps, 1) for k, v in agg.items()}
        out.update(steps=nsteps, sec=dt, frames_per_sec=frames / max(dt, 1e-9))
        out.update(prof.summary())
        return out

    def _train_epoch_device(self, epoch: int, t0: float) -> Dict[str, float]:
        """Epoch over the corpus resident on the device: only an int32
        index array crosses to the device a step. Frames count the padded
        rows, as the JAX trainer counts them."""
        d = self.cfg.data
        wgan = self.cfg.train.trainer == "wgan"
        group = self.cfg.train.n_critic + 1 if wgan else 1
        step_fn = self._wgan_step if wgan else self._lse_step
        prof = _EpochProfiler(
            self.workdir,
            self.cfg.train.profile_steps,
            active=epoch == self._profile_epoch and self.writer,
            device=self.device,
        )
        metrics_log = []
        for idx in self.dcorpus.epoch_indices(
            d.batch_size, group, epoch, seed=d.shuffle_seed,
            num_steps=self.cfg.train.steps_per_epoch,
        ):
            self.state, m = prof.step(
                step_fn, self.state, self.dcorpus.data, self.dcorpus.shard_indices(idx))
            metrics_log.append(m)
        agg = self._readback(metrics_log)
        dt = time.time() - t0
        nsteps = len(metrics_log)
        frames = nsteps * group * d.batch_size * self.dcorpus.bound
        out = {k: v / max(nsteps, 1) for k, v in agg.items()}
        out.update(steps=nsteps, sec=dt, frames_per_sec=frames / max(dt, 1e-9))
        out.update(prof.summary())
        return out

    def _validate(self) -> float:
        """Frame-weighted masked validation MSE: per-batch (error sum, frame
        count) pairs accumulate across batches, so short final batches and
        zero-masked pad rows carry exactly their frame weight. The pairs
        stay on the device and are read back once; under a mesh each rank
        sums its rows and one all-reduce sums the ranks."""
        if self.valid_ds is None or len(self.valid_ds) == 0:
            return float("nan")
        d = self.cfg.data
        sums = []
        for b in self.valid_ds.batches(
            d.batch_size, d.bucket_bounds, shuffle=False, drop_remainder=False
        ):
            sums.append(torch.stack(self._eval_step(self.state, self._put(self._cast(b)))))
        err, frames = 0.0, 0.0
        for e, f in global_sum(torch.stack(sums), self.mesh).cpu().tolist():
            err += e
            frames += f
        return err / max(frames, 1.0)

    def _validate_measures(self, epoch: int) -> Optional[Dict[str, float]]:
        """Objective measures (MCD / F0 RMSE / VUV / GV / modulation
        spectrum) over the validation split through the generation path,
        every ``measures_every`` epochs; logged as ``"objective"``. Under a
        mesh every rank measures (each holds the same state, so none waits
        on another) and rank 0's scores are broadcast, so every rank
        decides on the same numbers."""
        cfg = self.cfg.train
        if (
            cfg.measures_every <= 0
            or self.measures_stats is None
            or self.valid_ds is None
            or len(self.valid_ds) == 0
            or (epoch + 1) % cfg.measures_every != 0
        ):
            return None
        from percivaltts_tpu_torch.eval.generate import generate

        obj = generate(
            self.cfg,
            self.state,
            self.valid_ds,
            self.measures_stats,
            outdir=os.path.join(self.workdir, "valid_gen"),
            synthesize=False,
        )
        if self.mesh is not None:
            obj = self.mesh.broadcast_object(obj)
        self.metrics.log("objective", epoch=epoch, **obj)
        return obj

    def _score(self, valid: float, obj: Optional[Dict[str, float]]) -> float:
        """The best-checkpoint score of ``TrainConfig.best_metric``: the
        validation MSE, the MCD, or MCD + best_gv_weight·|ln GV ratio|
        (NaN on an epoch without measures)."""
        cfg = self.cfg.train
        if cfg.best_metric not in ("mcd", "mcd_gv"):
            return valid
        if obj is None:
            return float("nan")
        if cfg.best_metric == "mcd":
            return obj["mcd_db"]
        return obj["mcd_db"] + cfg.best_gv_weight * abs(math.log(max(obj["gv_ratio"], 1e-6)))

    def train(self, epochs: Optional[int] = None) -> Dict[str, list]:
        cfg = self.cfg.train
        epochs = cfg.epochs if epochs is None else epochs
        start_epoch = int(self.state.epoch)
        # profile the first epoch after the first of THIS process; with a
        # single epoch to run, profile it
        self._profile_epoch = (
            start_epoch + 1 if epochs - start_epoch > 1 else start_epoch
        )
        history: Dict[str, list] = {"train": [], "valid": []}
        last_saved = start_epoch - 1
        epoch = start_epoch - 1
        for epoch in range(start_epoch, epochs):
            tr = self._train_epoch(epoch)
            va = self._validate()
            obj = self._validate_measures(epoch)
            self.state.epoch = epoch + 1
            self.metrics.log("epoch", epoch=epoch, valid=va, **tr)
            history["train"].append(tr)
            history["valid"].append(va)
            print_log(
                f"epoch {epoch}: loss={tr.get('loss', float('nan')):.5f} "
                f"valid={va:.5f} ({tr['frames_per_sec']:.0f} frames/s)"
            )

            # best-model score: the configured metric (a patience counts
            # evaluations of it, not epochs: with "mcd" it exists only every
            # measures_every epochs)
            score = self._score(va, obj)
            improved = score < self.best_valid if score == score else False
            if improved:
                self.best_valid = score
                self.best_epoch = epoch
                self._stale_evals = 0
            elif score == score:
                # patience counts evaluations of the configured metric
                self._stale_evals += 1
            if (epoch + 1) % cfg.checkpoint_every == 0 or improved:
                m = {"valid": float(va)} if va == va else {}
                if obj is not None:
                    m.update(obj)
                if score == score:
                    m["score"] = float(score)
                self.ckpt.save(epoch, self.state, metrics=m or None)
                last_saved = epoch
            if self.best_epoch >= 0 and self._stale_evals >= cfg.patience:
                print_log(
                    f"early stopping at epoch {epoch} "
                    f"(best {self.best_valid:.5f} @ {self.best_epoch})"
                )
                break
        # a run must always end restorable: short runs (epochs <
        # checkpoint_every) otherwise save nothing
        if epoch >= start_epoch and last_saved < epoch:
            self.ckpt.save(epoch, self.state, metrics=None)
        return history

    def close(self):
        self.metrics.close()
