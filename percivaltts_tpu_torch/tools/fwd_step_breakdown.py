"""Where a step of the tensor-core forward kernels goes, on the card.

    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown          # the mma kernels
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --wide   # the cluster kernels
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --simt --f32 [--route=simt | narrow_f32]
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --simt --f32 --grid
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --wide --f32 [--route=wide | wide_f32]
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --wide --stream \
        [--route=wide | wide_mma_stream]
    python -m percivaltts_tpu_torch.tools.fwd_step_breakdown --wide --stream --sweep

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

With ``--simt --f32`` the same for the one-block CUDA-core forwards in f32
(``csrc/bilstm_fwd.cu``, ``csrc/bigru_fwd.cu``, route ``"simt"``) at
(512, 8, 128) and (512, 32, 128) (``SIMT_SHAPES``), at the rows a block that
``lstm_cuda.rows_per_block`` gives them:

- ``full``;
- ``no_product``: the step's ``h · W_h`` loop removed (at H = 128 the LSTM
  reads its f32 W_h through L1/L2, the GRU from shared memory);
- ``no_gates``: σ and tanh replaced by the identity;
- ``no_sync``: the step's two ``__syncthreads`` removed;
- ``loop_only``: neither gates nor product (the syncs kept);

beside the CUDA-core cluster forward (``"wide"``, ``csrc/{bilstm,bigru}_fwd_wide.cu``,
``full`` only) on the same inputs, a second baseline; and the cluster
forwards that replaced them there (``csrc/{bilstm,bigru}_fwd_narrow_f32.cu``,
route ``"narrow_f32"``, whose kernel body ``narrow_f32_fwd.cuh``, plan and
product ``narrow_f32_common.cuh`` and gate phases ``f32_cells.cuh`` are
inlined into each variant's source) at the plan the variant's library
gives, printed:

- ``full``, ``no_product``, ``no_gates`` as above;
- ``no_dsmem``: h written into the block's own buffer only;
- ``no_cluster_sync``: the step's split cluster barrier replaced by the
  block's ``__syncthreads`` (one cluster barrier before the blocks exit);
  neither applies to the kernel that holds W_h in registers (one block, no
  cluster), where these two are ``full`` again;
- ``no_prefetch``: the next step's input gates not loaded;
- ``no_store``: y (and c) not written;
- ``loop_only``: all of the above removed.

``--route=simt`` / ``--route=narrow_f32`` times one route alone. With
``--grid`` it times the ``"narrow_f32"`` forwards alone at every split and R
their plan weighs (``narrow_f32_layout.candidates(..., fwd=True)``, and the
resident kernel where ``reg_fits``), each at B = R (one cluster a
direction) and H = 64, 96 (LSTM), 128 and 256 (LSTM) / 320 (GRU), beside the
plan's step estimate (``fwd_step_cost``, ``reg_step_cost``), which these
times fit.

With ``--wide --f32`` the f32 cluster forwards at ``WIDE_SHAPES``: the
CUDA-core ones (``csrc/{bilstm,bigru}_fwd_wide.cu``, route ``"wide"``), full /
no_product (the k loops removed) / no_gates / no_dsmem / no_cluster_sync
(the step's ``cluster.sync`` a ``__syncthreads``, one cluster barrier before
the blocks exit) / loop_only; and the ones that replaced them
(``csrc/{bilstm,bigru}_fwd_wide_f32.cu``, route ``"wide_f32"``, with
``wide_f32_fwd.cuh`` and ``f32_cells.cuh`` inlined), at the plan the
variant's library gives (8 or 4 rows a cluster, printed): no_product (neither the register chunks nor the
shared-memory ones multiplied), no_gates, no_dsmem (h sent to the block's
own buffer only, its mbarrier armed for those bytes), no_exchange (neither
the sends nor the mbarriers, one cluster barrier before the blocks exit),
no_prefetch, no_store,
loop_only (no_product, no_gates, no_exchange, no_prefetch and no_store at
once). ``--route=wide`` / ``--route=wide_f32`` times one route alone.

With ``--wide --stream`` the bf16 cluster forwards past the widths whose
``W_hᵀ`` slice fits a block, at (512, 8, 1024), (512, 32, 1024) and
(512, 160, 1024) (``STREAM_SHAPES``): the CUDA-core ones
(``csrc/{bilstm,bigru}_fwd_wide.cu``, route ``"wide"``, the edits of
``--wide --f32`` at bf16) and the streamed tensor-core ones that replaced
them (``csrc/{bilstm,bigru}_fwd_wide_mma_stream.cu``, route
``"wide_mma_stream"``, with ``wide_mma_stream.cuh`` inlined), at the plan the
variant's library gives (printed): full; no_product (the chunks' products
removed, their ring hand-offs kept); no_gates; no_stream (each ring slot's
mbarrier armed with no copy: the slots keep what they held and nothing
crosses from L2); no_exchange (no DSMEM writes of h); no_cluster_sync (the
step's cluster barriers replaced by the compute warps' own barrier, one
cluster barrier before the blocks exit); loop_only (all of them at once).
``--route=wide`` / ``--route=wide_mma_stream`` times one route alone.
With ``--sweep`` it times the streamed forwards (``SWEEP``'s widths, H =
640 / 704, 1024 and 1536 / 1792) as the port builds them at the plan's
choice and at the rows a cluster forced (16, 24, 32 at B = 32; 40, 48, 56,
64 at B = 160), and copies of them built with a deeper ring
(``SWEEP_RINGS``: ``kWsRing`` of 4, 6 or 8 slots, the rest of the room
resident) at B = 1, 8, 32, printing each plan beside its µs a step; the
plan's step estimate is fitted to these.

Times are medians of CUDA-event times over 20 launches (5 runs of 3 for the
cluster kernels), without cells; the card's name and power limit are printed
first.
"""

from __future__ import annotations

import ctypes
import re
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
    # the last argument: rows (the plan's) for "wide_mma", the dtype code for "wide"
    tail = [T, B, H, plan.Hb, plan.U,
            0 if route == "wide_mma" or ins["gx"][0].dtype == torch.float32 else 1]
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


SIMT_SHAPES = [(512, 8, 128), (512, 32, 128)]
SIMT_VARIANTS = ("full", "no_product", "no_gates", "no_sync", "loop_only")
SIMT_PRODUCT = ("    for (int k = 0; k < H; ++k) {\n",
                "    for (int k = 0; false && k < H; ++k) {\n")
SIMT_STEP_SYNC = re.compile(r"    __syncthreads\(\);  // s_[zgh][^\n]*\n")


def _simt_source(src: str, name: str) -> str:
    """The one-block forward ``src`` with variant ``name``'s edits."""
    parts = {"loop_only": ("no_product", "no_gates")}.get(name, (name,))
    if "no_product" in parts:
        if src.count(SIMT_PRODUCT[0]) != 1:
            raise AssertionError(f"no_product: the product loop appears {src.count(SIMT_PRODUCT[0])} times")
        src = src.replace(*SIMT_PRODUCT)
    if "no_gates" in parts:
        head, sep, body = src.partition("\nnamespace {\n")
        src = head + "\n" + IDENTITY + sep + body
    if name == "no_sync":
        src, n = SIMT_STEP_SYNC.subn("", src)
        if n != 2:
            raise AssertionError(f"no_sync: {n} step barriers, not 2")
    return src


def _build_simt_variants() -> dict:
    """The one-block forwards' variants, and the CUDA-core cluster forwards
    as they are: {(kind, name): library}, the latter under name "wide"."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        src = (_build.CSRC / f"{kind}_fwd.cu").read_text()
        sources = {f"simt_{name}": _simt_source(src, name) for name in SIMT_VARIANTS}
        sources["wide"] = (_build.CSRC / f"{kind}_fwd_wide.cu").read_text()
        for name, text in sources.items():
            cu = out_dir / f"{kind}_fwd_{name}.cu"
            cu.write_text(text)
            so = out_dir / f"{kind}_fwd_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


NARROW_VARIANTS = ("full", "no_product", "no_gates", "no_dsmem", "no_cluster_sync",
                   "no_prefetch", "no_store", "loop_only")
# {variant: [(text, replacement, count)]} on the inlined narrow_f32 source;
# "no_gates" also defines σ and tanh as the identity before the gate phases
# (the resident kernel's product, prefetch and stores too; it has no DSMEM
# and no cluster barrier)
NARROW_EDITS = {
    "no_product": [("    nf_product<R>(s_w, s_h + (s & 1) * R * H, s_z, H, NCP, warp);\n", "", 1),
                   ("    for (int i = 0; i < KQ; ++i) {\n", "    for (int i = 0; i < 0 * KQ; ++i) {\n",
                    1)],
    "no_dsmem": [("cluster.map_shared_rank(next, dst)[k] = hv[i];", "next[k] = hv[i];", 1)],
    "no_cluster_sync": [
        ("    if (U > 1) cluster_arrive();  // this block's h of step s stored in every block\n",
         "", 1),
        ("      cluster_wait();  // every block's h of step s stored, every z of step s read\n",
         "      __syncthreads();\n", 1),
        ("      __syncthreads();\n  }\n}\n\n// ---- W_h in registers",
         "      __syncthreads();\n  }\n  cluster.sync();\n}\n\n// ---- W_h in registers", 1)],
    "no_prefetch": [("    if (s + 1 < n_steps) prefetch(s + 1);\n", "", 1),
                    ("      if (s + 1 < n_steps) cell.load(op, frame(s + 1), row0 + q, u, row_ok);\n",
                     "", 1)],
    "no_store": [("      if (live(i) && row_ok(i)) cell.store(",
                  "      if (false && live(i) && row_ok(i)) cell.store(", 1),
                 ("      if (row_ok) cell.store(", "      if (false && row_ok) cell.store(", 1)],
}


def _narrow_source(kind: str, name: str) -> str:
    """``csrc/{kind}_fwd_narrow_f32.cu`` with its headers inlined and the
    edits of variant ``name`` (all of them, and no_gates, for ``loop_only``)."""
    unpragma = lambda text: text.replace("#pragma once\n", "")  # noqa: E731
    src = (_build.CSRC / f"{kind}_fwd_narrow_f32.cu").read_text()
    gates = name in ("no_gates", "loop_only")
    cells = '#include "lstm_common.cuh"\n' + (IDENTITY if gates else "") + unpragma(
        (_build.CSRC / "f32_cells.cuh").read_text())
    src = src.replace('#include "f32_cells.cuh"\n', cells)
    body = unpragma((_build.CSRC / "narrow_f32_fwd.cuh").read_text()).replace(
        '#include "narrow_f32_common.cuh"\n',
        unpragma((_build.CSRC / "narrow_f32_common.cuh").read_text()))
    src = src.replace('#include "narrow_f32_fwd.cuh"\n', body)
    for part in NARROW_EDITS if name == "loop_only" else [name]:
        for old, new, count in NARROW_EDITS.get(part, []):
            if src.count(old) != count:
                raise AssertionError(f"{kind} narrow_f32 {part}: {old!r} appears "
                                     f"{src.count(old)} times")
            src = src.replace(old, new)
    return src


def _build_narrow_variants() -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        for name in NARROW_VARIANTS:
            cu = out_dir / f"{kind}_fwd_narrow_f32_{name}.cu"
            cu.write_text(_narrow_source(kind, name))
            so = out_dir / f"{kind}_fwd_narrow_f32_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


def _narrow_launcher(lib, kind: str, T: int, B: int, H: int, ins: dict, blocks: int = 0,
                     rows: int = 0, resident: int = -1):
    """A function that launches one narrow_f32 forward variant on ``ins`` (no
    cells) at the plan its library gives (``blocks``, ``rows``, ``resident``:
    its overrides), and that plan."""
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    p, i = ctypes.c_void_p, ctypes.c_int
    plan_fn = getattr(lib, f"percival_{kind}_fwd_narrow_f32_plan")
    plan_fn.argtypes, plan_fn.restype = [i] * 5 + [ctypes.POINTER(ctypes.c_int)], i
    out = (ctypes.c_int * 9)()
    if plan_fn(B, H, blocks, rows, resident, out):
        raise RuntimeError(f"{kind} narrow_f32 forward: no plan at B={B} H={H}")
    plan = nf.Plan(*out)
    wp = list(ins["wh"]) if plan.resident else [nf.pack_wh(w, nf.Split(*plan[:4]))
                                                for w in ins["wh"]]
    ptrs = [t.data_ptr() for t in (*ins["gx"], *wp)]
    ptrs += [t.data_ptr() for t in ins["bn"]] if kind == "bigru" else []
    ptrs += [t.data_ptr() for t in ins["y"]] + ([None, None] if kind == "bilstm" else [])
    fn = getattr(lib, f"percival_{kind}_fwd_narrow_f32")
    fn.argtypes, fn.restype = [p] * 8 + [i] * 7 + [p], i
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, T, B, H, plan.Hb, plan.U, plan.R, plan.resident, stream)
        if err:
            raise RuntimeError(f"{kind} narrow_f32 forward: CUDA error {err}")
    launch.keep = wp
    return launch, plan


def _f32_inputs(kind: str, T: int, B: int, H: int, dev, g) -> dict:
    """Random f32 inputs of one forward launch (both directions), and its outputs."""
    gates = 4 if kind == "bilstm" else 3
    pair = lambda *shape, s=1.0: [torch.randn(*shape, generator=g, device=dev) * s  # noqa: E731
                                  for _ in range(2)]
    return {"gx": pair(T, B, gates * H), "wh": pair(H, gates * H, s=H ** -0.5),
            "bn": pair(H), "y": [torch.empty(T, B, H, device=dev) for _ in range(2)]}


GRID_WIDTHS = {"bilstm": (64, 96, 128, 256), "bigru": (64, 128, 320)}


def grid_main() -> int:
    """The ``"narrow_f32"`` forwards at every candidate split and R of
    ``GRID_WIDTHS``, one cluster a direction (B = R), beside the step estimate."""
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    dev = torch.device("cuda")
    lib = _build.library()
    g = torch.Generator(device=dev).manual_seed(0)
    T = 512
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for H in GRID_WIDTHS[kind]:
            cands = [(s, R, 0) for s, R, _ in nf.candidates(H, gates, fwd=True)]
            cands += [(nf.split(H, 1, gates), R, 1) for R in nf.REG_ROWS if nf.reg_fits(H, gates)]
            for s, R, resident in cands:
                ins = _f32_inputs(kind, T, R, H, dev, g)
                launch, plan = _narrow_launcher(lib, kind, T, R, H, ins, blocks=s.U, rows=R,
                                                resident=resident)
                us = _time_ms(launch, launches=5) / T * 1e3
                estimate = (nf.reg_step_cost(H, gates, R) if resident
                            else nf.fwd_step_cost(H, s, R))
                print(f"[grid] {kind}_fwd_narrow_f32 H={H} U={plan.U} Hb={plan.Hb} NCP={plan.NCP} "
                      f"R={R} resident={resident} smem={plan.smem}: {us:.3f} us a step, estimate "
                      f"{estimate} cycles")
    return 0


def simt_main(only: str = "") -> int:
    """The one-block f32 forwards' variants at ``SIMT_SHAPES``, beside the
    f32 ``"wide"`` forward on the same inputs, and the ``"narrow_f32"``
    forwards' variants (``only``: one route alone)."""
    from percivaltts_tpu_torch.ops.lstm_cuda import rows_per_block

    if only in ("", "narrow_f32"):
        narrow_libs = _build_narrow_variants()
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        for kind in ("bilstm", "bigru"):
            for T, B, H in SIMT_SHAPES:
                ins = _f32_inputs(kind, T, B, H, dev, g)
                row, plan = [], None
                for name in NARROW_VARIANTS:
                    launch, plan = _narrow_launcher(ctypes.CDLL(str(narrow_libs[(kind, name)])),
                                                    kind, T, B, H, ins)
                    row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_fwd_narrow_f32 T,B,H={(T, B, H)} f32 (U={plan.U}, "
                      f"R={plan.R}, {plan.clusters} clusters at once, {plan.waves} waves, "
                      f"{plan.smem} B): us a step: " + ", ".join(row))
    if only not in ("", "simt"):
        return 0
    libs = _build_simt_variants()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in SIMT_SHAPES:
            ins = _f32_inputs(kind, T, B, H, dev, g)
            ptrs = [t.data_ptr() for t in (*ins["gx"], *ins["wh"])]
            ptrs += [t.data_ptr() for t in ins["bn"]] if kind == "bigru" else []
            ptrs += [t.data_ptr() for t in ins["y"]] + ([None, None] if kind == "bilstm" else [])
            rows = rows_per_block(B, n_sm)
            row = []
            for name in SIMT_VARIANTS:
                fn = getattr(ctypes.CDLL(str(libs[(kind, f"simt_{name}")])), f"percival_{kind}_fwd")
                fn.argtypes, fn.restype = [p] * len(ptrs) + [i] * 5 + [p], i

                def launch():
                    err = fn(*ptrs, T, B, H, 0, rows, stream)
                    if err:
                        raise RuntimeError(f"{kind} simt {name}: CUDA error {err}")
                row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
            wide = _wide_launcher(ctypes.CDLL(str(libs[(kind, "wide")])), kind, "wide", T, B, H, ins)
            row.append(f"wide full {_time_ms(wide, launches=3) / T * 1e3:.3f}")
            print(f"[breakdown] {kind}_fwd simt T,B,H={(T, B, H)} f32 (R={rows}, "
                  f"{2 * -(-B // rows)} blocks): us a step: " + ", ".join(row))
    return 0


WIDE_F32_VARIANTS = ("full", "no_product", "no_gates", "no_dsmem", "no_cluster_sync",
                     "loop_only")
# {variant: [(text, replacement, count)]} on csrc/{bilstm,bigru}_fwd_wide.cu
# (the same text in both); "no_gates" defines σ and tanh as the identity
# before the anonymous namespace; "loop_only" applies every one
OLD_WIDE_EDITS = {
    "no_product": [("    for (; k + 4 <= k1; k += 4) {\n",
                    "    for (; false && k + 4 <= k1; k += 4) {\n", 1),
                   ("    for (; k < k1; ++k) {\n", "    for (; false && k < k1; ++k) {\n", 1)],
    "no_dsmem": [("cluster.map_shared_rank(hn, dst)", "(hn)", 1)],
    # (one cluster barrier before the blocks exit: none may leave while
    # another still writes into its shared memory)
    "no_cluster_sync": [("    // this step's s_h and s_part done\n    cluster.sync();\n  }\n}\n",
                         "    // this step's s_h and s_part done\n    __syncthreads();\n  }\n"
                         "  cluster.sync();\n}\n", 1)],
}


def _old_wide_source(kind: str, name: str) -> str:
    """``csrc/{kind}_fwd_wide.cu`` with the edits of variant ``name``."""
    src = (_build.CSRC / f"{kind}_fwd_wide.cu").read_text()
    parts = list(OLD_WIDE_EDITS) + ["no_gates"] if name == "loop_only" else [name]
    if "no_gates" in parts:
        head, sep, body = src.partition("\nnamespace {\n")
        src = head + "\n" + IDENTITY + sep + body
    for part in parts:
        for old, new, count in OLD_WIDE_EDITS.get(part, []):
            if src.count(old) != count:
                raise AssertionError(f"{kind} wide {part}: {old!r} appears "
                                     f"{src.count(old)} times")
            src = src.replace(old, new)
    return src


NEW_WIDE_F32_VARIANTS = ("full", "no_product", "no_gates", "no_dsmem", "no_exchange",
                         "no_prefetch", "no_store", "loop_only")
_ARM = "    if (send && tid == 0) mbar_expect_tx(&s_bar[(s + 1) & 1], 4 * R * H);\n  }\n}\n"
# {variant: [(text, replacement, count)]} on csrc/{bilstm,bigru}_fwd_wide_f32.cu
# with wide_f32_fwd.cuh inlined; "no_gates" also defines σ and tanh as the
# identity before the gate phases; "loop_only" applies no_product, no_gates,
# no_exchange, no_prefetch and no_store
NEW_WIDE_EDITS = {
    "no_product": [("    for (int i = 0; i < NREG; ++i) quad(wr[i], i * kWfChunk + x0);\n",
                    "    for (int i = 0; i < 0 * NREG; ++i) quad(wr[i], i * kWfChunk + x0);\n", 1),
                   ("    for (int ch = NREG; ch < NCH; ++ch) {\n      if (x0 >= chunk_rows(ch))",
                    "    for (int ch = NREG; false && ch < NCH; ++ch) {\n      if (x0 >= chunk_rows(ch))",
                    1)],
    # h sent into the block's own buffer only, its mbarrier armed with those bytes
    "no_dsmem": [("          if ((lane & 3) + 4 * n < U) st_async16(",
                  "          if ((lane & 3) + 4 * n == rank) st_async16(", 1),
                 ("mbar_expect_tx(&s_bar[(s + 1) & 1], 4 * R * H)",
                  "mbar_expect_tx(&s_bar[(s + 1) & 1], 4 * R * nu)", 1)],
    # no sends, no waits, the mbarriers never armed; one cluster barrier
    # before the blocks exit
    "no_exchange": [("      if (send && uq < H) {\n", "      if (false && send && uq < H) {\n", 1),
                    ("    if (s > 0) mbar_wait(&s_bar[s & 1], ((s - 1) >> 1) & 1);\n", "", 1),
                    (_ARM, "  }\n  cluster.sync();\n}\n", 1)],
    "no_prefetch": [("    if (send) prefetch(s + 1);\n", "", 1)],
    "no_store": [("      if (pair_at(i, r, u) && u < nu && row0 + r < B)\n",
                  "      if (false && pair_at(i, r, u))\n", 1)],
}
LOOP_ONLY = ("no_product", "no_exchange", "no_prefetch", "no_store")


def _new_wide_source(kind: str, name: str) -> str:
    """``csrc/{kind}_fwd_wide_f32.cu`` with ``wide_f32_fwd.cuh`` and
    ``f32_cells.cuh`` inlined and the edits of variant ``name``."""
    unpragma = lambda text: text.replace("#pragma once\n", "")  # noqa: E731
    src = (_build.CSRC / f"{kind}_fwd_wide_f32.cu").read_text()
    gates = name in ("no_gates", "loop_only")
    cells = '#include "lstm_common.cuh"\n' + (IDENTITY if gates else "") + unpragma(
        (_build.CSRC / "f32_cells.cuh").read_text())
    src = src.replace('#include "f32_cells.cuh"\n', cells)
    src = src.replace('#include "wide_f32_fwd.cuh"\n',
                      unpragma((_build.CSRC / "wide_f32_fwd.cuh").read_text()))
    for part in LOOP_ONLY if name == "loop_only" else [name]:
        for old, new, count in NEW_WIDE_EDITS.get(part, []):
            if src.count(old) != count:
                raise AssertionError(f"{kind} wide_f32 {part}: {old!r} appears "
                                     f"{src.count(old)} times")
            src = src.replace(old, new)
    return src


def _build_wide_f32_variants(only: str = "") -> dict:
    """The f32 ``"wide"`` forwards' variants and the ``"wide_f32"`` ones:
    {(kind, route, name): library} (``only``: one route's)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    routes = (("wide", WIDE_F32_VARIANTS, _old_wide_source),
              ("wide_f32", NEW_WIDE_F32_VARIANTS, _new_wide_source))
    for kind in ("bilstm", "bigru"):
        for route, names, source in routes:
            if only and route != only:
                continue
            for name in names:
                cu = out_dir / f"{kind}_fwd_{route}_{name}.cu"
                cu.write_text(source(kind, name))
                so = out_dir / f"{kind}_fwd_{route}_{name}.so"
                cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                             "-o", str(so), str(cu)])
                libs[(kind, route, name)] = so
    _build._run_all(cmds)
    return libs


def _new_wide_launcher(lib, kind: str, T: int, B: int, H: int, ins: dict):
    """A function that launches one ``"wide_f32"`` forward variant on ``ins``
    (no cells), and the plan its library gives."""
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf

    p, i = ctypes.c_void_p, ctypes.c_int
    split = wide_layout.plan(H, 4 if kind == "bilstm" else 3)
    plan_fn = getattr(lib, f"percival_{kind}_fwd_wide_f32_plan")
    plan_fn.argtypes, plan_fn.restype = [i] * 4 + [ctypes.POINTER(ctypes.c_int)], i
    out = (ctypes.c_int * 9)()
    if plan_fn(B, H, split.Hb, split.U, out):
        raise RuntimeError(f"{kind} wide_f32 forward: no plan at B={B} H={H}")
    plan = dict(zip(("U", "Hb", "NC", "R", "nres", "nreg", "clusters", "waves", "smem"), out))
    wp = [wide_layout.pack_wh(w, split) for w in ins["wh"]]
    ptrs = [t.data_ptr() for t in (*ins["gx"], *wp)]
    ptrs += [t.data_ptr() for t in ins["bn"]] if kind == "bigru" else []
    ptrs += [t.data_ptr() for t in ins["y"]] + ([None, None] if kind == "bilstm" else [])
    fn = getattr(lib, f"percival_{kind}_fwd_wide_f32")
    fn.argtypes, fn.restype = [p] * 8 + [i] * 5 + [p], i
    stream = torch.cuda.current_stream().cuda_stream
    assert wf.fwd_rows(B, H, split.NC // split.Hb, plan["clusters"]).nreg == plan["nreg"]

    def launch():
        err = fn(*ptrs, T, B, H, split.Hb, split.U, stream)
        if err:
            raise RuntimeError(f"{kind} wide_f32 forward: CUDA error {err}")
    launch.keep = wp
    return launch, plan


def wide_f32_main(only: str = "") -> int:
    """The f32 ``"wide"`` forwards' variants and the ``"wide_f32"`` ones at
    ``WIDE_SHAPES`` (``only``: one route alone)."""
    libs = _build_wide_f32_variants(only)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in WIDE_SHAPES:
            ins = _f32_inputs(kind, T, B, H, dev, g)
            if only in ("", "wide"):
                row = []
                for name in WIDE_F32_VARIANTS:
                    launch = _wide_launcher(ctypes.CDLL(str(libs[(kind, "wide", name)])), kind,
                                            "wide", T, B, H, ins)
                    row.append(f"{name} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_fwd_wide T,B,H={(T, B, H)} f32: us a step: "
                      + ", ".join(row), flush=True)
            if only in ("", "wide_f32"):
                row, plan = [], {}
                for name in NEW_WIDE_F32_VARIANTS:
                    launch, plan = _new_wide_launcher(
                        ctypes.CDLL(str(libs[(kind, "wide_f32", name)])), kind, T, B, H, ins)
                    row.append(f"{name} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_fwd_wide_f32 T,B,H={(T, B, H)} ({plan}): us a step: "
                      + ", ".join(row), flush=True)
    return 0


STREAM_SHAPES = [(512, 8, 1024), (512, 32, 1024), (512, 160, 1024)]
STREAM_VARIANTS = ("full", "no_product", "no_gates", "no_stream", "no_exchange", "no_cluster_sync",
                   "loop_only")
# {variant: [(text, replacement, count)]} on csrc/{bilstm,bigru}_fwd_wide_mma_stream.cu
# with its headers inlined (the same text in both); "no_gates" defines σ and
# tanh as the identity before the anonymous namespace; "loop_only" applies every one
STREAM_EDITS = {
    "no_product": [("        percival::wsf_product<",
                    "        if (false) percival::wsf_product<", 1)],
    "no_stream": [("        ws_mbar_expect_tx(&full[slot], bytes);\n"
                   "        ws_bulk_load(s_ring + (size_t)slot * tile, wp + (size_t)(g % nstr) * "
                   "tile, bytes,\n                     &full[slot]);\n",
                   "        ws_mbar_arrive(&full[slot]);\n", 1)],
    "no_exchange": [("        if (!last)\n          for (int dst = lane >> ",
                     "        if (false)\n          for (int dst = lane >> ", 1)],
    # (one cluster barrier before the blocks exit: none may leave while
    # another still writes into its shared memory)
    "no_cluster_sync": [
        ("    if (!dbuf && !last) cluster_arrive();", "    (void)0;", 1),
        ("    if (!dbuf && !last) cluster_wait();", "    (void)0;", 1),
        ("    cluster_arrive();  // h of step s+1 landed in every block\n    cluster_wait();\n",
         "    percival::ws_compute_sync();\n", 1),
        ("    if (!dbuf) {  // the compute warps arrive after the product, wait before the "
         "exchange", "    if (false) {", 1),
        ("    cluster_arrive();  // h of step s + 1 landed\n    cluster_wait();\n", "", 1),
        ("dbuf, lane);\n    return;", "dbuf, lane);\n    cluster.sync();\n    return;", 1),
        ("  }\n}\n\nconst void* kernel_for", "  }\n  cluster.sync();\n}\n\nconst void* kernel_for",
         1)],
}


def _inline_headers(src: str, seen=None) -> str:
    """``src`` with each ``#include "x.cuh"`` of a header in ``csrc/``
    replaced by the header's text, itself inlined, the first time it is
    included and dropped after (as ``#pragma once``)."""
    seen = set() if seen is None else seen

    def one(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        return _inline_headers((_build.CSRC / name).read_text().replace("#pragma once\n", ""), seen)
    return re.sub(r'#include "(\w+\.cuh)"\n', one, src)


def _stream_source(kind: str, name: str) -> str:
    """``csrc/{kind}_fwd_wide_mma_stream.cu`` with its headers inlined and the
    edits of variant ``name`` (every one, and no_gates, for ``loop_only``)."""
    src = _inline_headers((_build.CSRC / f"{kind}_fwd_wide_mma_stream.cu").read_text())
    parts = list(STREAM_EDITS) + ["no_gates"] if name == "loop_only" else [name]
    if "no_gates" in parts:
        head, sep, body = src.partition("\nnamespace {\n")
        src = head + "\n" + IDENTITY + sep + body
    for part in parts:
        for old, new, count in STREAM_EDITS.get(part, []):
            if src.count(old) != count:
                raise AssertionError(f"{kind} wide_mma_stream {part}: {old!r} appears "
                                     f"{src.count(old)} times")
            src = src.replace(old, new)
    return src


def _ring_source(kind: str, name: str) -> str:
    """The streamed forward of ``kind`` built with a ring of ``name`` (a
    number of slots) in place of ``kWsRing``'s 3."""
    old = "constexpr int kWsRing = 3;"
    src = _stream_source(kind, "full")
    if src.count(old) != 1:
        raise AssertionError(f"{kind} wide_mma_stream: {old!r} appears {src.count(old)} times")
    return src.replace(old, f"constexpr int kWsRing = {name};")


def _build_stream_variants(only: str = "", sweep: bool = False) -> dict:
    """The bf16 ``"wide"`` forwards' variants and the streamed ones:
    {(kind, route, name): library} (``only``: one route's); with ``sweep``
    the streamed ones at each ring depth of ``SWEEP_RINGS`` past 3 alone
    (``name``: the depth)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    routes = (("wide", WIDE_F32_VARIANTS, _old_wide_source),
              ("wide_mma_stream", STREAM_VARIANTS, _stream_source))
    if sweep:
        routes = (("wide_mma_stream", [str(r) for r in SWEEP_RINGS if r != 3], _ring_source),)
    for kind in ("bilstm", "bigru"):
        for route, names, source in routes:
            if only and route != only:
                continue
            for name in names:
                cu = out_dir / f"{kind}_fwd_{route}_{name}.cu"
                cu.write_text(source(kind, name))
                so = out_dir / f"{kind}_fwd_{route}_{name}.so"
                cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                             "-o", str(so), str(cu)])
                libs[(kind, route, name)] = so
    _build._run_all(cmds)
    return libs


def _stream_launcher(lib, kind: str, T: int, B: int, H: int, ins: dict, rows: int = 0):
    """A function that launches one streamed forward variant on ``ins`` (no
    cells), and the plan its library gives (``rows``: R forced, 0 the plan's
    choice)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    split = wide_mma_layout.plan(H, 4 if kind == "bilstm" else 3)
    plan_fn = getattr(lib, f"percival_{kind}_fwd_wide_mma_stream_plan")
    plan_fn.argtypes, plan_fn.restype = [i] * 5 + [ctypes.POINTER(ctypes.c_int)], i
    out = (ctypes.c_int * 11)()
    if plan_fn(B, H, split.Hb, split.U, rows, out):
        raise RuntimeError(f"{kind} wide_mma_stream forward: no plan at B={B} H={H} "
                           f"rows={rows}")
    plan = wide_mma_layout.StreamFwdPlan(*out)
    wp = [wide_mma_layout.pack_wh_stream(w, split) for w in ins["wh"]]
    ptrs = [t.data_ptr() for t in (*ins["gx"], *wp)]
    ptrs += [t.data_ptr() for t in ins["bn"]] if kind == "bigru" else []
    ptrs += [t.data_ptr() for t in ins["y"]] + ([None, None] if kind == "bilstm" else [])
    fn = getattr(lib, f"percival_{kind}_fwd_wide_mma_stream")
    fn.argtypes, fn.restype = [p] * 8 + [i] * 6 + [p], i
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, T, B, H, split.Hb, split.U, rows, stream)
        if err:
            raise RuntimeError(f"{kind} wide_mma_stream forward: CUDA error {err}")
    launch.keep = wp
    return launch, plan


def stream_main(only: str = "") -> int:
    """The bf16 ``"wide"`` forwards' variants and the streamed ones at
    ``STREAM_SHAPES`` (``only``: one route alone)."""
    libs = _build_stream_variants(only)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in STREAM_SHAPES:
            ins = {k: [t.to(bf16) for t in v]
                   for k, v in _f32_inputs(kind, T, B, H, dev, g).items()}
            if only in ("", "wide"):
                row = []
                for name in WIDE_F32_VARIANTS:
                    launch = _wide_launcher(ctypes.CDLL(str(libs[(kind, "wide", name)])), kind,
                                            "wide", T, B, H, ins)
                    row.append(f"{name} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_fwd_wide T,B,H={(T, B, H)} bf16: us a step: "
                      + ", ".join(row), flush=True)
            if only in ("", "wide_mma_stream"):
                row, plan = [], None
                for name in STREAM_VARIANTS:
                    launch, plan = _stream_launcher(
                        ctypes.CDLL(str(libs[(kind, "wide_mma_stream", name)])), kind, T, B, H, ins)
                    row.append(f"{name} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_fwd_wide_mma_stream T,B,H={(T, B, H)} bf16 (R {plan.R}, "
                      f"{plan.PPW} pairs a warp, {plan.nres} resident / "
                      f"{plan.nstr} streamed "
                      f"chunks, {plan.waves} waves, {1 + plan.dbuf} h buffers): us a step: "
                      + ", ".join(row), flush=True)
    return 0


SWEEP = {"bilstm": (640, 1024, 1536), "bigru": (704, 1024, 1792)}
SWEEP_RINGS = (3, 4, 6, 8)
SWEEP_ROWS = {32: (16, 24, 32), 160: (40, 48, 56, 64)}


def sweep_main() -> int:
    """The streamed forwards at ``SWEEP``'s widths: the kernel library's at
    the plan's choice, then the deeper rings' and the library's at forced
    rows a cluster (a forced R whose block does not fit prints ``-``)."""
    lib = _build.library()
    rings = {}
    for (kind, _, name), so in _build_stream_variants(sweep=True).items():
        rings.setdefault(int(name), {})[kind] = ctypes.CDLL(str(so))
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    T = 512
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for H in SWEEP[kind]:
            for B in (1, 8, 32, 160):
                ins = {k: [t.to(bf16) for t in v]
                       for k, v in _f32_inputs(kind, T, B, H, dev, g).items()}
                forced = [(0, 3)] + [(0, r) for r in SWEEP_RINGS if r != 3 and B <= 32]
                forced += [(R, 3) for R in SWEEP_ROWS.get(B, ())]
                row = []
                for rows, ring in forced:
                    rlib = lib if ring == 3 else rings[ring][kind]
                    try:
                        launch, plan = _stream_launcher(rlib, kind, T, B, H, ins, rows)
                    except RuntimeError:
                        row.append(f"rows {rows} ring {ring}: -")
                        continue
                    us = _time_ms(launch, launches=3) / T * 1e3
                    row.append(f"rows {rows} ring {ring} (R {plan.R}, PPW {plan.PPW}, "
                               f"{plan.nres} resident / {plan.nstr} streamed, "
                               f"{plan.waves} waves, dbuf {plan.dbuf}): {us:.3f}")
                print(f"[sweep] {kind}_fwd_wide_mma_stream T,B,H={(T, B, H)} bf16 us a step: "
                      + "; ".join(row), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_step_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--simt" in sys.argv[1:]:
        if "--f32" not in sys.argv[1:]:
            print("fwd_step_breakdown: --simt times the f32 kernels: add --f32", file=sys.stderr)
            return 2
        if "--grid" in sys.argv[1:]:
            return grid_main()
        only = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")), "")
        return simt_main(only)
    if "--wide" in sys.argv[1:]:
        only = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")), "")
        if "--f32" in sys.argv[1:]:
            return wide_f32_main(only)
        if "--stream" in sys.argv[1:]:
            return sweep_main() if "--sweep" in sys.argv[1:] else stream_main(only)
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
