"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers: the build
takes seconds, not minutes). The library lives under ``build/kernels/``
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
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


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; their joined output, or raise on the
    first that failed (after all have ended)."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/*.cu`` into ``LIBRARY`` when it is missing or older
    than a source (always when ``force``): one ``nvcc -c`` per source, all
    at once, then one link. Objects and library are written under temporary
    names and the library is renamed into place, so a concurrent loader
    never sees a half-written file."""
    if not force and not _stale():
        return BuildResult(LIBRARY, 0.0, "")
    srcs = sources()
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, LIBRARY.name)
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIBRARY)
    return BuildResult(LIBRARY, time.perf_counter() - t0, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if stale), with every entry
    point's C signature declared: pointers and the stream as ``c_void_p``,
    so ctypes never truncates them to 32-bit ints."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.percival_bilstm_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.percival_bilstm_fwd.restype = i
    lib.percival_bilstm_fwd_mma.argtypes = [p] * 8 + [i, i, i, p]
    lib.percival_bilstm_fwd_mma.restype = i
    lib.percival_bilstm_bwd.argtypes = [p] * 14 + [i, i, i, i, i, p]
    lib.percival_bilstm_bwd.restype = i
    lib.percival_bilstm_bwd_mma.argtypes = [p] * 16 + [i, i, i, p]
    lib.percival_bilstm_bwd_mma.restype = i
    lib.percival_bilstm_fwd_wide.argtypes = [p] * 8 + [i, i, i, i, i, i, p]
    lib.percival_bilstm_fwd_wide.restype = i
    lib.percival_bilstm_bwd_wide.argtypes = [p] * 14 + [i, i, i, i, i, i, p]
    lib.percival_bilstm_bwd_wide.restype = i
    lib.percival_bigru_fwd_wide.argtypes = [p] * 8 + [i, i, i, i, i, i, p]
    lib.percival_bigru_fwd_wide.restype = i
    lib.percival_bigru_bwd_wide.argtypes = [p] * 14 + [i, i, i, i, i, i, p]
    lib.percival_bigru_bwd_wide.restype = i
    for fn in (lib.percival_bilstm_bwd_wide_mma, lib.percival_bigru_bwd_wide_mma):
        fn.argtypes = [p] * 14 + [i, i, i, i, i, p]
        fn.restype = i
    # the streamed BPTTs also take the deep layout's scratch for the dh partials
    for fn in (lib.percival_bilstm_bwd_wide_mma_stream, lib.percival_bigru_bwd_wide_mma_stream):
        fn.argtypes = [p] * 15 + [i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.percival_bilstm_bwd_narrow_f32, lib.percival_bigru_bwd_narrow_f32,
               lib.percival_bilstm_bwd_wide_f32, lib.percival_bigru_bwd_wide_f32):
        fn.argtypes = [p] * 14 + [i, i, i, i, i, i, p]
        fn.restype = i
    for fn in (lib.percival_bilstm_fwd_narrow_f32, lib.percival_bigru_fwd_narrow_f32):
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = i
    for plan in (lib.percival_bilstm_bwd_narrow_f32_plan, lib.percival_bigru_bwd_narrow_f32_plan):
        plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    for plan in (lib.percival_bilstm_fwd_narrow_f32_plan, lib.percival_bigru_fwd_narrow_f32_plan):
        plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    for plan in (lib.percival_bilstm_bwd_wide_mma_plan, lib.percival_bigru_bwd_wide_mma_plan,
                 lib.percival_bilstm_bwd_wide_mma_stream_plan,
                 lib.percival_bigru_bwd_wide_mma_stream_plan,
                 lib.percival_bilstm_fwd_wide_f32_plan, lib.percival_bigru_fwd_wide_f32_plan):
        plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    for plan in (lib.percival_bilstm_bwd_wide_f32_plan, lib.percival_bigru_bwd_wide_f32_plan):
        plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    for fn in (lib.percival_bilstm_fwd_wide_f32, lib.percival_bigru_fwd_wide_f32):
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = i
    for fn in (lib.percival_bilstm_fwd_wide_mma, lib.percival_bigru_fwd_wide_mma,
               lib.percival_bilstm_fwd_wide_mma_stream, lib.percival_bigru_fwd_wide_mma_stream):
        fn.argtypes = [p] * 8 + [i, i, i, i, i, i, p]
        fn.restype = i
    for plan in (lib.percival_bilstm_fwd_wide_mma_plan, lib.percival_bigru_fwd_wide_mma_plan,
                 lib.percival_bilstm_fwd_wide_mma_stream_plan,
                 lib.percival_bigru_fwd_wide_mma_stream_plan):
        plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    for plan in (lib.percival_bilstm_fwd_wide_plan, lib.percival_bilstm_bwd_wide_plan,
                 lib.percival_bigru_fwd_wide_plan, lib.percival_bigru_bwd_wide_plan):
        plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = i
    lib.percival_bigru_fwd.argtypes = [p] * 8 + [i, i, i, i, i, p]
    lib.percival_bigru_fwd.restype = i
    lib.percival_bigru_fwd_mma.argtypes = [p] * 8 + [i, i, i, p]
    lib.percival_bigru_fwd_mma.restype = i
    lib.percival_bigru_bwd.argtypes = [p] * 14 + [i, i, i, i, i, p]
    lib.percival_bigru_bwd.restype = i
    lib.percival_bigru_bwd_mma.argtypes = [p] * 16 + [i, i, i, p]
    lib.percival_bigru_bwd_mma.restype = i
    lib.percival_frame_window.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.percival_frame_window.restype = i
    ll = ctypes.c_longlong
    lib.percival_overlap_add.argtypes = [p, p, i, i, i, i, i, ll, ll, i, p]
    lib.percival_overlap_add.restype = i
    lib.percival_cuda_error_string.argtypes = [i]
    lib.percival_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().percival_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
