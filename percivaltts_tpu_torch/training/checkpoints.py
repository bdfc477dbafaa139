"""Checkpoint / resume (counterpart of
``percivaltts_tpu/training/checkpoints.py``).

Reference parity: percivaltts writes Keras ``.h5`` weights on validation
improvement and its ``cont`` flag reloads them to continue training. One
checkpoint holds both networks, both Adam states, the step generator's
state, the epoch and step counters and the EMA (``GANState.state_dict``).

The JAX package keeps them in Orbax directories, which need jax to read;
the port has its own format: one directory per step,
``<directory>/<step>/`` holding ``state.pt`` (``torch.save`` of the state
dict) and ``metrics.json``. A save is written into ``<step>.tmp/`` and then
renamed, so a crash leaves no half checkpoint, and a leftover ``.tmp``
directory is never read. Retention and the best-step queries are Orbax's,
as the JAX class configures them.

Under a data-parallel mesh every rank holds the same state, so rank 0
alone writes and removes checkpoints, and every rank then waits at a
barrier; each rank keeps the same record of the retained steps and
restores the same files (the directory must be one that every rank sees).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from percivaltts_tpu_torch.training.state import GANState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _score(metrics: Optional[Mapping]) -> float:
    """The ranking metric (the trainer's configured best metric, lower is
    better); a save whose metrics lack it ranks last."""
    return (metrics or {}).get("score", float("inf"))


class CheckpointManager:
    """LatestN ∪ BestN checkpoints of a :class:`GANState` (or any state
    dict) under ``directory``.

    Retention is the JAX class's: after each save, a checkpoint stays if it
    is one of the ``keep`` newest, or one of the ``keep`` best by
    ``metrics["score"]`` among those saved with metrics (a save with
    metrics but no score ranks last; one saved with ``metrics=None`` counts
    only toward the newest). While no more than ``keep`` exist, all stay.
    Ties rank by step, the newer first. A save at a step not past the latest
    is skipped, as Orbax skips it."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        """``mesh``: rank 0 writes, and every rank waits for the write."""
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.mesh = mesh
        self._writes = mesh is None or mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)
        self._metrics: Dict[int, Optional[dict]] = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and os.path.isfile(os.path.join(path, STATE_FILE)):
                with open(os.path.join(path, METRICS_FILE)) as f:
                    self._metrics[int(name)] = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return sorted(self._metrics)

    def save(self, step: int, state, metrics: Optional[dict] = None) -> bool:
        """Write ``state`` (a :class:`GANState`, or a state dict) at
        ``step``, then apply retention; synchronous. Returns False (and
        writes nothing) when ``step`` is not past the latest step."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        if self._writes:
            payload = state.state_dict() if isinstance(state, GANState) else state
            final = self._path(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f)
            os.replace(tmp, final)
        self._metrics[step] = metrics
        for old in self._steps_to_remove():
            if self._writes:
                shutil.rmtree(self._path(old))
            del self._metrics[old]
        if self.mesh is not None:
            self.mesh.barrier()
        return True

    def _steps_to_remove(self) -> List[int]:
        """Orbax's ``AnyPreservationPolicy([LatestN(keep), BestN(score,
        reverse=True, n=keep, keep_checkpoints_without_metrics=False)])``
        over the retained steps."""
        steps = self.all_steps()
        if len(steps) <= self.keep:
            return []
        if self.keep == 0:
            return steps
        kept = set(steps[-self.keep:]) | set(self._ranked()[-self.keep:])
        return [s for s in steps if s not in kept]

    def _ranked(self) -> List[int]:
        """Steps saved with metrics, worst first, best last (a stable sort
        on the descending score: among equal scores the newer ranks
        better)."""
        with_metrics = [s for s in self.all_steps() if self._metrics[s] is not None]
        return sorted(with_metrics, key=lambda s: _score(self._metrics[s]), reverse=True)

    def metrics(self, step: int) -> Optional[dict]:
        return self._metrics.get(step)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """Step with the best recorded score (falls back to latest when no
        metrics were recorded)."""
        ranked = self._ranked()
        return ranked[-1] if ranked else self.latest_step()

    def best_score(self) -> Optional[Tuple[int, float]]:
        """(step, score) of the best retained checkpoint, or None — lets a
        resumed Trainer re-seed its best-metric/early-stopping tracking
        instead of resetting it."""
        ranked = self._ranked()
        if not ranked:
            return None
        m = self._metrics[ranked[-1]]
        if not m or "score" not in m:
            return None
        return ranked[-1], float(m["score"])

    def load(self, step: int, device) -> Dict[str, Any]:
        """The state dict saved at ``step``, its tensors on ``device``."""
        path = os.path.join(self._path(step), STATE_FILE)
        return torch.load(path, weights_only=True, map_location=torch.device(device))

    def restore(
        self,
        state: GANState,
        step: Optional[int] = None,
        best: bool = False,
    ) -> GANState:
        """Load the checkpoint at ``step`` (the latest; with ``best=True``
        the best-scored) into ``state``, a GANState built from the same
        config (the reference's rebuild-model + load-weights resume), in
        place, and return it.

        The EMA is reconciled with what the checkpoint holds, as in the JAX
        class: a checkpoint's EMA is restored even when ``state`` has none
        (so ``eval_params`` serves the weights the run selected on); a
        ``state`` that expects an EMA over a checkpoint without one gets it
        seeded from the restored live parameters in f32, as
        ``make_gan_state`` seeds it from the init."""
        if step is None:
            step = self.best_step() if best else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        device = next(state.gen.parameters()).device
        wants_ema = state.ema is not None
        state.load_state_dict(self.load(step, device))
        if wants_ema and state.ema is None:
            state.ema = {n: p.detach().float().clone() for n, p in state.gen.named_parameters()}
        return state
