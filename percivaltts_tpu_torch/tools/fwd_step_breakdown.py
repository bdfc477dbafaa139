"""Where a step of the tensor-core forward kernels goes, on the card.

    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown

Builds variants of ``csrc/bilstm_fwd_mma.cu`` and ``csrc/bigru_fwd_mma.cu``
with one part of the step removed or replaced (macros and edits applied to a
copy of the source under ``build/kernels/variants/``; a variant's outputs
are not the recurrence's) and times each, one launch of both directions, at
the forward's training and serving shapes. Prints µs a step per variant:

- ``full``: the kernel as the port builds it;
- ``no_gates``: σ and tanh replaced by the identity (the gate math's cost);
- ``fast_gates``: ``__expf``, ``__fdividef`` and ``tanh.approx`` (what the
  accurate transcendentals that the port keeps cost);
- ``no_mma``: the ``mma.sync`` calls removed (the product's cost);
- ``no_sync``: the step's ``__syncthreads`` removed;
- ``loop_only``: neither gates nor products.

Times are medians of CUDA-event times over 20 launches; the card's name and
power limit are printed first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops.mma_layout import pack_wh

SHAPES = [(512, 8, 128), (512, 160, 128)]
FAST = """
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#define tanhf(x) fast_tanh(x)
#define sigmoid_f32(x) __fdividef(1.0f, 1.0f + __expf(-(x)))
"""
IDENTITY = "#define tanhf(x) (x)\n#define sigmoid_f32(x) (x)\n"
NO_MMA = "#define mma_bf16_16816(d, a, b) ((void)0)\n"
VARIANTS = {"full": "", "no_gates": IDENTITY, "fast_gates": FAST, "no_mma": NO_MMA,
            "no_sync": "", "loop_only": IDENTITY + NO_MMA}
STEP_SYNC = "    __syncthreads();              // …for every thread, and h is complete\n"


def _variant_source(src: str, name: str) -> str:
    head, sep, body = src.partition("\nnamespace {\n")
    out = head + "\n" + VARIANTS[name] + sep + body
    if name == "no_sync":
        assert STEP_SYNC in out
        out = out.replace(STEP_SYNC, "")
    return out


def _build_variants() -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        src = (_build.CSRC / f"{kind}_fwd_mma.cu").read_text()
        for name in VARIANTS:
            cu = out_dir / f"{kind}_{name}.cu"
            cu.write_text(_variant_source(src, name))
            so = out_dir / f"{kind}_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


def _time_ms(fn, launches: int = 20, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_step_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = _build_variants()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in SHAPES:
            gx = [torch.randn(T, B, gates * H, generator=g, device=dev).to(bf16) for _ in range(2)]
            wp = [pack_wh((torch.randn(H, gates * H, generator=g, device=dev) / H ** 0.5).to(bf16),
                          kind[2:]) for _ in range(2)]
            bn = [torch.randn(H, generator=g, device=dev).to(bf16) for _ in range(2)]
            y = [torch.empty(T, B, H, dtype=bf16, device=dev) for _ in range(2)]
            row = []
            for name in VARIANTS:
                lib = ctypes.CDLL(str(libs[(kind, name)]))
                fn = getattr(lib, f"percival_{kind}_fwd_mma")
                fn.argtypes, fn.restype = [p] * 8 + [i, i, i, p], i
                ptrs = [t.data_ptr() for t in (*gx, *wp)]
                ptrs += [t.data_ptr() for t in bn] if kind == "bigru" else []
                ptrs += [t.data_ptr() for t in y] + ([None, None] if kind == "bilstm" else [])

                def launch():
                    err = fn(*ptrs, T, B, H, stream)
                    if err:
                        raise RuntimeError(f"{kind} {name}: CUDA error {err}")
                row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
            print(f"[breakdown] {kind}_fwd_mma T,B,H={(T, B, H)}: us a step: " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
