"""Where a step of the tensor-core forward kernels goes, on the card.

    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown          # the mma kernels
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --wide   # the cluster kernels

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

With ``--wide`` it does the same for the tensor-core cluster forwards of H
past one block (``csrc/{bilstm,bigru}_fwd_wide_mma.cu``), bf16, at
(512, 8, 512), (512, 32, 512) and (512, 160, 512) (``WIDE_SHAPES``), each
beside the CUDA-core cluster forward it replaced (``*_fwd_wide.cu``,
``full`` only):

- ``full``;
- ``no_mma``: every ``mma.sync`` removed (the product's tensor-core work; its
  ldmatrix reads stay);
- ``no_gates``: σ and tanh replaced by the identity;
- ``no_dsmem``: the all-gather's writes into the block's own shared memory
  instead of every block's (distributed shared memory);
- ``no_cluster_sync``: the step's cluster barrier (and the split barrier's
  halves) replaced by the block's ``__syncthreads`` (one cluster barrier
  kept before the blocks exit);
- ``loop_only``: all of the above at once;
- ``no_kparts``: each cell's whole K on its cell warp, the warps that took
  its other K parts idle (the same work as ``full`` where the plan has one
  part: the spread between the two there is the measurement's own).

Times are medians of CUDA-event times over 20 launches (5 runs of 3 for the
cluster kernels), without cells; the card's name and power limit are printed
first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops import wide_layout, wide_mma_layout
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


WIDE_SHAPES = [(512, 8, 512), (512, 32, 512), (512, 160, 512)]
WIDE_VARIANTS = ("full", "no_mma", "no_gates", "no_dsmem", "no_cluster_sync", "loop_only",
                 "no_kparts")
# {variant: [(text, replacement, count)]} on csrc/*_fwd_wide_mma.cu (macros go
# before the anonymous namespace); "loop_only" applies every one
WIDE_EDITS = {
    "no_mma": [],
    "no_gates": [],
    "no_dsmem": [("cluster.map_shared_rank(next, dst)", "(next)", 1)],
    # (one cluster barrier before the blocks exit: none may leave while
    # another still writes into its shared memory)
    "no_cluster_sync": [("cluster_arrive();", "(void)0;", 1),
                        ("cluster_wait();", "__syncthreads();", 1),
                        ("    cluster.sync();  // h of step s+1 landed in every block\n",
                         "    __syncthreads();\n", 1),
                        ("  }\n}\n\nconst void* kernel_for",
                         "  }\n  cluster.sync();\n}\n\nconst void* kernel_for", 1)],
}
WIDE_MACROS = {"no_mma": NO_MMA, "no_gates": IDENTITY}
# not one of loop_only's: it removes no work, it moves it
NO_KPARTS = [("  if (TPW > 1) ksp = 1;", "  ksp = 1;", 1)]


def _wide_source(src: str, name: str) -> str:
    if name == "no_kparts":
        for old, new, count in NO_KPARTS:
            if src.count(old) != count:
                raise AssertionError(f"no_kparts: {old!r} appears {src.count(old)} times")
            src = src.replace(old, new)
        return src
    names = list(WIDE_EDITS) if name == "loop_only" else [name] if name in WIDE_EDITS else []
    head, sep, body = src.partition("\nnamespace {\n")
    src = head + "\n" + "".join(WIDE_MACROS.get(n, "") for n in names) + sep + body
    for variant in names:
        for old, new, count in WIDE_EDITS[variant]:
            n = src.count(old)
            if n != count:
                raise AssertionError(f"{variant}: {old!r} appears {n} times, not {count}")
            src = src.replace(old, new)
    return src


def _build_wide_variants() -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        for route, names in (("wide_mma", WIDE_VARIANTS), ("wide", ("full",))):
            src = (_build.CSRC / f"{kind}_fwd_{route}.cu").read_text()
            for name in names:
                cu = out_dir / f"{kind}_fwd_{route}_{name}.cu"
                cu.write_text(_wide_source(src, name) if route == "wide_mma" else src)
                so = out_dir / f"{kind}_fwd_{route}_{name}.so"
                cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                             "-o", str(so), str(cu)])
                libs[(kind, route, name)] = so
    _build._run_all(cmds)
    return libs


def _wide_launcher(lib, kind: str, route: str, T: int, B: int, H: int, ins: dict):
    """A function that launches one variant's forward on ``ins`` (both
    directions, no cells; its W_h packed for the route)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gates = 4 if kind == "bilstm" else 3
    layout = wide_mma_layout if route == "wide_mma" else wide_layout
    plan = layout.plan(H, gates)
    wp = [layout.pack_wh(w, plan) for w in ins["wh"]]
    ptrs = [t.data_ptr() for t in (*ins["gx"], *wp)]
    ptrs += [t.data_ptr() for t in ins["bn"]] if kind == "bigru" else []
    ptrs += [t.data_ptr() for t in ins["y"]] + ([None, None] if kind == "bilstm" else [])
    tail = [T, B, H, plan.Hb, plan.U, 0 if route == "wide_mma" else 1]  # rows: the plan's / bf16
    fn = getattr(lib, f"percival_{kind}_fwd_{route}")
    fn.argtypes, fn.restype = [p] * 8 + [i] * 6 + [p], i

    def launch():
        err = fn(*ptrs, *tail, stream)
        if err:
            raise RuntimeError(f"{kind} {route}: CUDA error {err}")
    launch.keep = wp  # the packed W_h lives as long as the launcher
    return launch


def wide_main() -> int:
    libs = _build_wide_variants()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in WIDE_SHAPES:
            pair = lambda *shape, s=1.0: [(torch.randn(*shape, generator=g, device=dev) * s).to(bf16)  # noqa: E731
                                          for _ in range(2)]
            ins = {"gx": pair(T, B, gates * H), "wh": pair(H, gates * H, s=H ** -0.5),
                   "bn": pair(H), "y": [torch.empty(T, B, H, dtype=bf16, device=dev)
                                        for _ in range(2)]}
            row = []
            for route, names in (("wide", ("full",)), ("wide_mma", WIDE_VARIANTS)):
                for name in names:
                    launch = _wide_launcher(ctypes.CDLL(str(libs[(kind, route, name)])), kind,
                                            route, T, B, H, ins)
                    label = "old full" if route == "wide" else name
                    row.append(f"{label} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
            print(f"[breakdown] {kind}_fwd_wide_mma T,B,H={(T, B, H)}: us a step: "
                  + ", ".join(row))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_step_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--wide" in sys.argv[1:]:
        return wide_main()
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
