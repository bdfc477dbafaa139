"""Logging + structured metrics (the port's copy of ``print_log``,
``MetricsLogger`` and ``read_metrics`` from
``percivaltts_tpu/utils/logging.py``): timestamped stdout lines and an
append-only JSONL record of metrics, read back by ``read_metrics``."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any, Dict, Optional


def print_log(msg: str, file: Optional[IO] = None) -> None:
    """Timestamped log line. The stream is resolved at call time, so a
    redirected ``sys.stdout`` is honoured."""
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{ts}] {msg}", file=file if file is not None else sys.stdout, flush=True)


class MetricsLogger:
    """Append-only JSONL metrics log: each record carries a wall-clock
    timestamp, a ``kind`` tag and numeric fields. ``enabled=False`` makes
    every write a no-op (it still returns the record)."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self._f = None
        if enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "kind": kind}
        for k, v in fields.items():
            # unwrap tensor / numpy scalars so the record is plain JSON
            if hasattr(v, "item"):
                try:
                    v = v.item()
                except Exception:
                    v = float(v)
            rec[k] = v
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str, kind: Optional[str] = None):
    """Read a JSONL metrics file back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out
