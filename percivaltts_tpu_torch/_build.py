"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers: the
build takes seconds, not minutes). The library lives under ``build/kernels/``
at the root of the checkout and is rebuilt at first use and whenever a source
is newer than it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIBRARY = BUILD_DIR / "libpercival_torch_kernels.so"

# sm_90a: the Hopper target that also admits wgmma/setmaxnreg in later kernels
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel in the log
)


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was up to date
    log: str  # nvcc's output (ptxas resource usage), empty when not rebuilt


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built on the "
        "machine that has the card"
    )


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    deps = sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` into ``LIBRARY`` when it is missing or older
    than a source (always when ``force``). The library is written to a
    temporary name and renamed into place, so a concurrent loader never sees
    a half-written file."""
    if not force and not _stale():
        return BuildResult(LIBRARY, 0.0, "")
    srcs = sources()
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(LIBRARY, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if stale), with every entry
    point's C signature declared: pointers and the stream as ``c_void_p``,
    so ctypes never truncates them to 32-bit ints."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.percival_bilstm_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.percival_bilstm_fwd.restype = i
    lib.percival_cuda_error_string.argtypes = [i]
    lib.percival_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().percival_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
