"""Where a step of the BPTT kernels goes, on the card.

    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown          # the mma kernels
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --wide   # the cluster kernels
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --wide --stream [--route=wide]
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --wide --stream --deep
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --deep-fit=LOG  # on the CPU
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --wide --f32 [--route=wide_f32]
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --wide --f32 --few [--route=wide_f32_few] [--grid]
    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown --simt --f32 [--route=narrow_f32]

Builds variants of ``csrc/bilstm_bwd_mma.cu`` and ``csrc/bigru_bwd_mma.cu``
with one part of the step removed or replaced (macros and edits applied to a
copy of the source under ``build/kernels/variants/``, as
``fwd_step_breakdown`` does for the forwards; a variant's outputs are not
the BPTT's) and times each, one launch of both directions, at the training
shape and at B=8. Prints µs a step per variant:

- ``full``: the kernel as the port builds it;
- ``no_gates``: σ and tanh replaced by the identity (the gate math's cost);
- ``fast_gates``: ``__expf``, ``__fdividef`` and ``tanh.approx``;
- ``no_chain``: the chained product's ``mma.sync`` removed (dh no longer
  depends on the step before through the tensor cores; its B fragments are
  still read);
- ``no_mma``: every ``mma.sync`` removed (both products);
- ``no_sync``: the step's ``__syncthreads`` removed;
- ``loop_only``: neither gates nor products.

With ``--wide`` it does the same for the cluster kernels of H past one
block (``csrc/{bilstm,bigru}_bwd_wide.cu``, and ``*_bwd_wide_mma.cu`` when
present), bf16, at (512, 8, 512) and (512, 160, 512) (``WIDE_SHAPES``):

- ``full``;
- ``no_recompute``: the gate recompute ``h_prev · W_h`` of the next step
  removed (its accumulators are never written);
- ``no_dh``: the ``dgates · W_hᵀ`` product removed, with its writes (the
  time it saves also holds what it kept the next barrier waiting);
- ``no_dsmem``: the product's partials written into the block's own shared
  memory instead of their owners' (distributed shared memory);
- ``no_cluster_sync``: the step's cluster barrier(s) replaced by the
  block's ``__syncthreads`` (one cluster barrier kept before the blocks
  exit);
- ``no_prefetch``: the ``h_prev`` rows of the step after next not loaded;
- ``loop_only``: all of the above removed: the gate phase, its loads and
  stores, and the loop.

With ``--wide --stream --deep`` the streamed BPTTs' deep layout alone (past
the 64-k layout's widths; the deep kernels' text in the same sources) at
``DEEP_SHAPES`` (H = 2048 at B = 8 / 32 / 160, the widest, 4096, at B = 8 /
32), each
plan printed: ``full``, ``no_recompute``, ``no_dh``, ``no_partials`` (no sum
of the dh partials from L2 before the gate phase), ``no_cluster_sync`` (the step's cluster
barrier replaced by the compute warps' own), ``no_stream`` (each ring slot
armed with no copy of W_hᵀ or h_prev), ``loop_only`` (all of them) and
``ring3`` (the plan's block with its ring cut to 3 slots). ``--deep-fit=LOG``
fits the deep layout's step estimate to the ``full`` steps in the saved
output ``LOG`` of such a run (on the CPU).

With ``--wide --f32`` the same variants in f32 on the CUDA-core cluster
kernels (``"wide"``) and the f32 cluster BPTTs (``"wide_f32"``,
``csrc/{bilstm,bigru}_bwd_wide_f32.cu``, whose kernel body is
``wide_f32_common.cuh``: its edits apply to a copy inlined into the
variant's source), the latter also without the streamed chunks
(``no_stream``: the ring's slots keep the chunks of the first pass), each
shape's launch plan printed; ``--route=NAME`` times one route alone;
``--few`` times them at the few batch rows of ``FEW_SHAPES`` in place of
``WIDE_SHAPES`` (the chunked kernels at R = 8), and beside them the route's
few-row kernels (``"wide_f32_few"``, ``csrc/wide_f32_few.cuh``, the plan's
R; ``FEW_VARIANTS``: full, no_recompute, no_dh, no_dsmem, no_prefetch and
loop_only, all three removed); ``--grid`` then times their full step at
``FEW_GRID``'s widths, every R that fits, one and three clusters a
direction. The headers of ``"wide_f32"`` are inlined into each variant's
source, each once.

With ``--simt --f32`` the same for the one-block CUDA-core BPTTs in f32
(``csrc/bilstm_bwd.cu``, ``csrc/bigru_bwd.cu``, route ``"simt"``) at
(512, 8, 128) and (512, 32, 128) (``SIMT_SHAPES``), at the rows a block
that ``lstm_cuda.rows_per_block`` gives them:

- ``full``;
- ``no_recompute``: the recompute of the next step's gates removed;
- ``no_dh``: the ``dz · W_hᵀ`` reduction removed (one warp a row of k);
- ``no_gates``: σ and tanh replaced by the identity;
- ``no_sync``: the step's two ``__syncthreads`` removed;
- ``loop_only``: neither gates nor products (the syncs kept);

and beside them the cluster kernels that replaced them there
(``csrc/{bilstm,bigru}_bwd_narrow_f32.cu``, route ``"narrow_f32"``, whose
kernel body ``narrow_f32_common.cuh`` and gate phases ``f32_cells.cuh`` are
inlined into each variant's source), each shape's plan printed:

- ``full``, ``no_recompute``, ``no_dh``, ``no_gates`` as above;
- ``no_dsmem``: the dh partials stored into the block's own slots;
- ``no_cluster_sync``: the step's split cluster barrier removed (the
  block's ``__syncthreads`` stay; one cluster barrier before the blocks
  exit);
- ``no_prefetch``: the next step's gate operands not loaded;
- ``no_store``: the step's dgates not written to dgx (and dnr);
- ``loop_only``: all of the above removed.

``--route=simt`` / ``--route=narrow_f32`` times one route alone.

Times are medians of CUDA-event times over 20 launches (5 runs of 3 for the
cluster kernels); the card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops import wide_layout, wide_mma_layout
from percivaltts_tpu_torch.ops.mma_layout import pack_wh
from percivaltts_tpu_torch.tools.fwd_step_breakdown import FAST, IDENTITY, NO_MMA, _time_ms

SHAPES = [(512, 32, 128), (512, 8, 128)]
NO_CHAIN = "#define chain_mma(d, a, b) ((void)0)\n"
VARIANTS = {"full": "", "no_gates": IDENTITY, "fast_gates": FAST, "no_chain": NO_CHAIN,
            "no_mma": NO_MMA + NO_CHAIN, "no_sync": "", "loop_only": IDENTITY + NO_MMA + NO_CHAIN}
STEP_SYNC = re.compile(r"    __syncthreads\(\);\s+// …for every thread, and the d[gz] tile is complete\n")
CHAIN_MMA = "mma_bf16_16816(d["  # the chained product's calls: accumulators d[chain]


def _variant_source(src: str, name: str) -> str:
    head, sep, body = src.partition("\nnamespace {\n")
    assert CHAIN_MMA in body
    body = body.replace(CHAIN_MMA, "chain_mma(d[")
    defs = VARIANTS[name]
    if "chain_mma" not in defs:  # the chained product stays
        defs += "#define chain_mma mma_bf16_16816\n"
    out = head + "\n" + defs + sep + body
    if name == "no_sync":
        out, n = STEP_SYNC.subn("", out)
        assert n == 1
    return out


def _build_variants() -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        src = (_build.CSRC / f"{kind}_bwd_mma.cu").read_text()
        for name in VARIANTS:
            cu = out_dir / f"{kind}_bwd_{name}.cu"
            cu.write_text(_variant_source(src, name))
            so = out_dir / f"{kind}_bwd_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


WIDE_SHAPES = [(512, 8, 512), (512, 160, 512)]
# --wide --stream: bf16 past the widths whose W_hᵀ slice fits a block's shared
# memory, where "wide" ran until "wide_mma_stream" took over
STREAM_SHAPES = [(512, 8, 1024), (512, 32, 1024), (512, 160, 1024)]
# --few: the f32 BPTT's few batch rows (B <= 8) at the widths where the
# CUDA-core cluster kernel ("wide") was measured faster than the chunked
# "wide_f32" plan, by cell
FEW_SHAPES = {"bilstm": [(512, 2, 384), (512, 8, 384), (512, 6, 416)],
              "bigru": [(512, 2, 384), (512, 8, 384), (512, 6, 512)]}
WIDE_VARIANTS = ("full", "no_recompute", "no_dh", "no_dsmem", "no_cluster_sync", "no_prefetch",
                 "loop_only")
WIDE_ROUTE_VARIANTS = {"wide_f32": ("no_stream",),  # variants only some routes have
                       "wide_mma_stream": ("no_stream",)}
# --wide --stream --deep: the streamed BPTTs' deep layout (past the 64-k
# layout's widths, where "wide" ran before), timed alone ("wide" takes 0.3–4 s
# a call there: PERF.md, step 0)
DEEP_SHAPES = [(512, 8, 2048), (512, 32, 2048), (512, 160, 2048), (512, 8, 4096), (512, 32, 4096)]
DEEP_VARIANTS = ("full", "no_recompute", "no_dh", "no_partials", "no_cluster_sync", "no_stream",
                 "loop_only", "ring3")
# variants that change a setting rather than remove a part: never in loop_only
SETTING_VARIANTS = ("ring3",)
# the few-row kernels of "wide_f32" (csrc/wide_f32_few.cuh), timed as their
# own "route": no_dh also drops the mbarrier waits and arms its sends fed,
# no_dsmem sends every partial into the block's own slots and mbarrier (at
# the widths timed U·Hb = H, so the bytes a step still match)
FEW_VARIANTS = ("full", "no_recompute", "no_dh", "no_dsmem", "no_prefetch", "loop_only")
# --few --grid: the few-row kernels' full step at every R that fits, one and
# three clusters a direction, by cell and width (the plan's step estimate is
# fitted to it)
FEW_GRID = {"bilstm": (288, 384, 416), "bigru": (352, 384, 448, 512)}
# per source: {variant: [(text, replacement, count)]}; "loop_only" applies every edit
WIDE_EDITS = {
    "wide": {
        "no_recompute": [("      recompute();\n", "", 1)],
        "no_dh": [("for (int q0 = 0; q0 < items; q0 += NT) {",
                   "for (int q0 = 0; false && q0 < items; q0 += NT) {", -1),
                  ("for (int k = tid; k < H; k += NT) {",
                   "for (int k = tid; false && k < H; k += NT) {", -1)],
        "no_dsmem": [("cluster.map_shared_rank(next, dst)", "(next)", 1)],
        # (one cluster barrier before the blocks exit: none may leave while
        # another still writes into its shared memory)
        "no_cluster_sync": [("    cluster.sync();\n  }\n}",
                             "    __syncthreads();\n  }\n  cluster.sync();\n}", 1)],
        "no_prefetch": [("hp_next[i] = s + 2 < n_steps ? load_hp(frame(s + 2), i) : 0.0f;",
                         "hp_next[i] = 0.0f;", 1)],
    },
    "wide_f32": {
        "no_recompute": [("      if (a_warp) {\n", "      if (false && a_warp) {\n", 1)],
        "no_dh": [("        dh_chunk(wc, ch);\n", "", 1)],
        "no_dsmem": [("cluster.map_shared_rank(s_recv, owner)", "(s_recv)", 1)],
        "no_cluster_sync": [("cluster_arrive();", "(void)0;", 2),
                            ("cluster_wait();", "__syncthreads();", 3),
                            ("  cp_async_wait<0>();  // chunks streamed for a pass that does not come\n}",
                             "  cp_async_wait<0>();\n  cluster.sync();\n}", 1)],
        "no_prefetch": [("    if (ch > 0 && s + 2 < n_steps) load_h(frame(s + 2), ch - 1);\n", "", 1)],
        "no_stream": [("    issue();\n", "", 1)],
    },
    "wide_f32_few": {
        "no_recompute": [("    recompute();  // z of step s+1\n", "", 1)],
        "no_dh": [("    dh_product(s & 1);\n", "", 1),
                  ("    if (s > 0) mbar_wait(&s_bar[(s - 1) & 1], ((s - 1) >> 1) & 1);\n", "", 1),
                  ("if (tid == 0 && n_steps > 1) mbar_expect_tx", "if (false) mbar_expect_tx", 1),
                  ("if (tid == 0 && s + 2 < n_steps) mbar_expect_tx", "if (false) mbar_expect_tx",
                   1)],
        "no_dsmem": [("cluster_addr(recv_addr, owner)", "cluster_addr(recv_addr, rank)", 1),
                     ("cluster_addr(bar_addr, owner)", "cluster_addr(bar_addr, rank)", 1)],
        "no_prefetch": [("    prefetch(s + 1);\n", "", 1)],
    },
    # the streamed kernels (their header inlined): no_cluster_sync keeps the
    # prologue's barrier and one before the blocks exit; no_stream arms each
    # ring slot's mbarrier with no copy, so the slots keep what they held and
    # nothing crosses from L2
    "wide_mma_stream": {
        "no_recompute": [("      recompute(w, c);\n", "", 1)],
        "no_dh": [("      percival::ws_dh_chunk<kDhM, NT8>(cluster, w, s_dg, recv, c, H, Hb, NC, rank, "
                   "warp, lane);\n", "", 1)],
        "no_dsmem": [("cluster.map_shared_rank(recv, owner)", "(recv)", 1)],
        "no_cluster_sync": [
            ("    if (!dbuf) cluster_arrive();", "    (void)0;", 1),
            ("      if (c == 0 && !dbuf) cluster_wait();", "      (void)0;", 1),
            ("    cluster_arrive();   // step s's partials stored\n", "", 1),
            ("    cluster_wait();     // every partial of step s landed\n", "", 1),
            ("    if (!dbuf) {  // the compute warps arrive after the gate phase, wait after chunk 0",
             "    if (false) {", 1),
            ("of the next\n    cluster_arrive();\n    cluster_wait();\n", "of the next\n", 1),
            ("dbuf, lane);\n    return;", "dbuf, lane);\n    cluster.sync();\n    return;", 1),
            ("  cp_async_wait<0>();\n}\n\n// The deep layout",
             "  cp_async_wait<0>();\n  cluster.sync();\n}\n\n// The deep layout", 1)],
        "no_prefetch": [("    if (s + 2 < n_steps) load_h(frame(s + 2));\n", "", 1)],
        "no_stream": [("        ws_mbar_expect_tx(&full[slot], bytes);\n"
                       "        ws_bulk_load(s_ring + (size_t)slot * tile, wp + (size_t)(g % nstr) * "
                       "tile, bytes,\n                     &full[slot]);\n",
                       "        ws_mbar_arrive(&full[slot]);\n", 1)],
    },
    # the deep layout of the streamed kernels (the same sources, their deep
    # kernels' text): no_partials drops the block-wide sum of the other
    # blocks' dh partials from L2; no_cluster_sync keeps the block's compute
    # warps' own barrier; no_stream arms each ring slot's mbarrier with no
    # copy (neither the W_hᵀ tile nor the h_prev rows)
    "wide_mma_stream_deep": {
        "no_recompute": [("      if (np > 0)\n        percival::wd_recompute<",
                          "      if (false)\n        percival::wd_recompute<", 1)],
        "no_dh": [("      if (s_dh >= 0)\n        percival::wd_dh_chunk<NT8>",
                   "      if (false)\n        percival::wd_dh_chunk<NT8>", 1)],
        "no_partials": [("    if (s > 0) {  // every block's dh partials of step s − 1",
                         "    if (false) {  // every block's dh partials of step s − 1", 1)],
        "no_cluster_sync": [
            ("    cluster_arrive();   // step s's partials written to the scratch\n"
             "    cluster_wait();     // every block's partials of step s written\n",
             "    ws_compute_sync();\n", 1),
            ("    cluster_arrive();\n    cluster_wait();\n  }\n  upto(total);",
             "  }\n  upto(total);", 1)],
        "no_stream": [("      if (lane == 0) ws_mbar_expect_tx(&full[slot], tile_bytes + R * row_bytes);\n"
                       "      __syncwarp();\n"
                       "      if (lane == 0)\n"
                       "        ws_bulk_load(s_ring + (size_t)slot * tile, wp + (size_t)c * tile, "
                       "tile_bytes, &full[slot]);\n"
                       "      if (lane < R)\n"
                       "        ws_bulk_load(s_hr + (size_t)(slot * R + lane) * kWdHs,\n"
                       "                     hp + ((size_t)step_frame(pass) * B + row) * H + c * "
                       "kWdChunk, row_bytes,\n"
                       "                     &full[slot]);\n",
                       "      if (lane == 0) ws_mbar_arrive(&full[slot]);\n", 1)],
        # the plan's block (its shared memory) with the ring cut to 3 slots
        "ring3": [("int nres = plan.nres, dbuf = plan.dbuf, ring = plan.ring;",
                   "int nres = plan.nres, dbuf = plan.dbuf, ring = 3;", 1)],
    },
    "wide_mma": {
        "no_recompute": [("    recompute(0, KH);   // step s+1, first half\n", "", 1),
                         ("    recompute(KH, KS);  // step s+1, second half\n", "", 1)],
        "no_dh": [("    dh_product(s_recv + (dbuf & (s + 1)) * slots);", "", 1)],
        "no_dsmem": [("cluster.map_shared_rank(recv, owner)", "(recv)", 1)],
        "no_cluster_sync": [("cluster_arrive();", "(void)0;", 2),
                            ("cluster_wait();", "__syncthreads();", 2),
                            ("  cp_async_wait<0>();\n}\n\nconst void* kernel_for",
                             "  cp_async_wait<0>();\n  cluster.sync();\n}\n\nconst void* kernel_for",
                             1)],
        "no_prefetch": [("    if (s + 2 < n_steps) load_h(frame(s + 2));\n", "", 1)],
    },
}


def _wide_source(src: str, route: str, name: str) -> str:
    """``src`` with the edits of variant ``name`` (all of them for
    ``loop_only``)."""
    edits = WIDE_EDITS[route]
    every = [v for v in edits if v not in SETTING_VARIANTS]
    for variant in (every if name == "loop_only" else [name] if name in edits else []):
        for old, new, count in edits[variant]:
            n = src.count(old)
            if count >= 0 and n != count:
                raise AssertionError(f"{route} {variant}: {old!r} appears {n} times, not {count}")
            src = src.replace(old, new)
    return src


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
        text = (_build.CSRC / name).read_text().replace("#pragma once\n", "")
        return _inline_headers(text, seen)
    return re.sub(r'#include "(\w+\.cuh)"\n', one, src)


def _source_route(route: str) -> str:
    """The route whose source a timed "route" edits: the few-row kernels'
    and the deep layout's live in their route's sources."""
    return route.removesuffix("_few").removesuffix("_deep")


def _variants(route: str) -> tuple:
    return {"wide_f32_few": FEW_VARIANTS, "wide_mma_stream_deep": DEEP_VARIANTS}.get(
        route, WIDE_VARIANTS + WIDE_ROUTE_VARIANTS.get(route, ()))


def _build_wide_variants(routes) -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        for route in routes:
            path = _build.CSRC / f"{kind}_bwd_{_source_route(route)}.cu"
            if not path.exists():
                continue
            src = path.read_text()
            if route.startswith(("wide_f32", "wide_mma_stream")):
                # the kernel bodies are (partly) headers': edit copies inlined
                src = _inline_headers(src)
            for name in _variants(route):
                cu = out_dir / f"{kind}_bwd_{route}_{name}.cu"
                cu.write_text(_wide_source(src, route, name))
                so = out_dir / f"{kind}_bwd_{route}_{name}.so"
                cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                             "-o", str(so), str(cu)])
                libs[(kind, route, name)] = so
    _build._run_all(cmds)
    return libs


SIMT_SHAPES = [(512, 8, 128), (512, 32, 128)]
SIMT_VARIANTS = ("full", "no_recompute", "no_dh", "no_gates", "no_sync", "loop_only")
SIMT_STEP_SYNC = re.compile(r"    __syncthreads\(\);  // s_d[zgh][ ,][^\n]*\n")
# per source: {variant: [(text, replacement, count)]}; "loop_only" applies
# no_recompute, no_dh and no_gates
SIMT_EDITS = {
    "bilstm": {"no_recompute": [("    if (more) {\n", "    if (false && more) {\n", 1)]},
    "bigru": {"no_recompute": [("      recompute(g_in);\n", "", 1)]},
}
SIMT_NO_DH = ("for (int k = warp; k < H; k += n_warps) {",
              "for (int k = warp; false && k < H; k += n_warps) {", 1)


def _simt_source(src: str, kind: str, name: str) -> str:
    """The one-block BPTT ``src`` of ``kind`` with variant ``name``'s edits."""
    edits = {**SIMT_EDITS[kind], "no_dh": [SIMT_NO_DH]}
    parts = {"loop_only": ("no_recompute", "no_dh", "no_gates")}.get(name, (name,))
    for part in parts:
        for old, new, count in edits.get(part, []):
            if src.count(old) != count:
                raise AssertionError(f"{kind} {part}: {old!r} appears {src.count(old)} times")
            src = src.replace(old, new)
    if "no_gates" in parts:
        head, sep, body = src.partition("\nnamespace {\n")
        src = head + "\n" + IDENTITY + sep + body
    if name == "no_sync":
        src, n = SIMT_STEP_SYNC.subn("", src)
        assert n == 2, n
    return src


def _build_simt_variants() -> dict:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for kind in ("bilstm", "bigru"):
        src = (_build.CSRC / f"{kind}_bwd.cu").read_text()
        for name in SIMT_VARIANTS:
            cu = out_dir / f"{kind}_bwd_simt_{name}.cu"
            cu.write_text(_simt_source(src, kind, name))
            so = out_dir / f"{kind}_bwd_simt_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


NARROW_VARIANTS = ("full", "no_recompute", "no_dh", "no_gates", "no_dsmem", "no_cluster_sync",
                   "no_prefetch", "no_store", "loop_only")
# {variant: [(text, replacement, count)]} on the inlined narrow_f32 source;
# "no_gates" also defines σ and tanh as the identity before the gate phases
NARROW_EDITS = {
    "no_recompute": [("    recompute(s_h + ((s + 1) & 1) * R * H);\n", "", 1)],
    "no_dh": [("    dh_product(s_recv + (s & 1) * slots);\n", "", 1)],
    "no_dsmem": [("cluster.map_shared_rank(recv, owner)", "(recv)", 1)],
    "no_cluster_sync": [("    cluster_arrive();  // this block's partials stored\n", "", 1),
                        ("    cluster_wait();   // every partial of step s stored\n", "", 1),
                        ("  store_pass(n_steps - 1);\n  cp_async_wait<0>();\n}",
                         "  store_pass(n_steps - 1);\n  cp_async_wait<0>();\n  cluster.sync();\n}", 1)],
    "no_prefetch": [("    prefetch(s + 1);\n", "", 1)],
    "no_store": [("    store_pass(s);\n", "", 1)],
}


def _narrow_source(kind: str, name: str) -> str:
    """``csrc/{kind}_bwd_narrow_f32.cu`` with its two headers inlined and the
    edits of variant ``name`` (all of them, and no_gates, for ``loop_only``)."""
    unpragma = lambda text: text.replace("#pragma once\n", "")  # noqa: E731
    src = (_build.CSRC / f"{kind}_bwd_narrow_f32.cu").read_text()
    gates = name in ("no_gates", "loop_only")
    cells = '#include "lstm_common.cuh"\n' + (IDENTITY if gates else "") + unpragma(
        (_build.CSRC / "f32_cells.cuh").read_text())
    src = src.replace('#include "f32_cells.cuh"\n', cells)
    src = src.replace('#include "narrow_f32_common.cuh"\n',
                      unpragma((_build.CSRC / "narrow_f32_common.cuh").read_text()))
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
            cu = out_dir / f"{kind}_bwd_narrow_f32_{name}.cu"
            cu.write_text(_narrow_source(kind, name))
            so = out_dir / f"{kind}_bwd_narrow_f32_{name}.so"
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
                         "-o", str(so), str(cu)])
            libs[(kind, name)] = so
    _build._run_all(cmds)
    return libs


def _narrow_launcher(lib, kind: str, T: int, B: int, H: int, ins: dict, outs: dict):
    """A function that launches one narrow_f32 variant on ``ins`` at the
    plan its library gives, and that plan."""
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    p, i = ctypes.c_void_p, ctypes.c_int
    plan_fn = getattr(lib, f"percival_{kind}_bwd_narrow_f32_plan")
    plan_fn.argtypes, plan_fn.restype = [i] * 4 + [ctypes.POINTER(ctypes.c_int)], i
    out = (ctypes.c_int * 8)()
    if plan_fn(B, H, 0, 0, out):
        raise RuntimeError(f"{kind} narrow_f32: no plan at B={B} H={H}")
    plan = nf.Plan(*out)
    wp = [nf.pack_wh(w, nf.Split(*plan[:4])) for w in ins["wh"]]
    names = ["gx", "wp"] + (["hp", "cp", "c", "dy"] if kind == "bilstm" else ["bn", "hp", "dy"])
    tensors = {**ins, "wp": wp}
    ptrs = [t.data_ptr() for n in names for t in tensors[n]]
    ptrs += [t.data_ptr() for n in (["dgx"] if kind == "bilstm" else ["dgx", "dnr"])
             for t in outs[n]]
    fn = getattr(lib, f"percival_{kind}_bwd_narrow_f32")
    fn.argtypes, fn.restype = [p] * len(ptrs) + [i] * 6 + [p], i
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, T, B, H, plan.Hb, plan.U, plan.R, stream)
        if err:
            raise RuntimeError(f"{kind} narrow_f32: CUDA error {err}")
    launch.keep = wp
    return launch, plan


def simt_main(only: str = "") -> int:
    """The one-block f32 BPTTs' variants at ``SIMT_SHAPES``, and the
    ``"narrow_f32"`` kernels' beside them (``only``: one route alone)."""
    from percivaltts_tpu_torch.ops.lstm_cuda import rows_per_block

    if only in ("", "narrow_f32"):
        narrow_libs = _build_narrow_variants()
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        for kind in ("bilstm", "bigru"):
            for T, B, H in SIMT_SHAPES:
                ins, outs = _wide_inputs(kind, T, B, H, dev, g, torch.float32)
                row, plan = [], None
                for name in NARROW_VARIANTS:
                    launch, plan = _narrow_launcher(ctypes.CDLL(str(narrow_libs[(kind, name)])),
                                                    kind, T, B, H, ins, outs)
                    row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_bwd_narrow_f32 T,B,H={(T, B, H)} f32 (U={plan.U}, "
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
    for kind in ("bilstm", "bigru"):
        for T, B, H in SIMT_SHAPES:
            ins, outs = _wide_inputs(kind, T, B, H, dev, g, torch.float32)
            names = ["gx", "wh"] + (["hp", "cp", "c", "dy"] if kind == "bilstm" else
                                    ["bn", "hp", "dy"])
            ptrs = [t.data_ptr() for n in names for t in ins[n]]
            ptrs += [t.data_ptr() for n in (["dgx"] if kind == "bilstm" else ["dgx", "dnr"])
                     for t in outs[n]]
            rows = rows_per_block(B, n_sm)
            row = []
            for name in SIMT_VARIANTS:
                fn = getattr(ctypes.CDLL(str(libs[(kind, name)])), f"percival_{kind}_bwd")
                fn.argtypes, fn.restype = [p] * len(ptrs) + [i] * 5 + [p], i

                def launch():
                    err = fn(*ptrs, T, B, H, 0, rows, stream)
                    if err:
                        raise RuntimeError(f"{kind} simt {name}: CUDA error {err}")
                row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
            print(f"[breakdown] {kind}_bwd simt T,B,H={(T, B, H)} f32 (R={rows}, "
                  f"{2 * -(-B // rows)} blocks): us a step: " + ", ".join(row))
    return 0


def _wide_inputs(kind: str, T: int, B: int, H: int, dev, g, dtype=torch.bfloat16):
    """Random inputs of one launch (both directions) in ``dtype``, and its outputs."""
    gates = 4 if kind == "bilstm" else 3
    pair = lambda *shape, s=1.0: [(torch.randn(*shape, generator=g, device=dev) * s).to(dtype)  # noqa: E731
                                  for _ in range(2)]
    ins = {"gx": pair(T, B, gates * H), "wh": pair(H, gates * H, s=H ** -0.5),
           "bn": pair(H), "hp": pair(T, B, H, s=0.5), "cp": pair(T, B, H, s=0.5),
           "c": pair(T, B, H, s=0.5), "dy": pair(T, B, H, s=0.5)}
    outs = {"dgx": [torch.empty_like(x) for x in ins["gx"]],
            "dnr": [torch.empty_like(x) for x in ins["hp"]]}
    return ins, outs


def _wide_launcher(lib, kind: str, route: str, T: int, B: int, H: int, ins: dict, outs: dict,
                   rows: int = 0):
    """A function that launches one variant's kernel on ``ins`` (its W_h packed
    for the route), and the route's plan as the variant's library reports it.
    ``"wide_f32"`` runs its chunked kernels (R = 8 or more: ``rows`` rows, or
    the plan's choice past 8 batch rows), ``"wide_f32_few"`` its few-row ones
    (``rows`` rows, or the plan's choice)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gates = 4 if kind == "bilstm" else 3
    f32 = ins["gx"][0].dtype == torch.float32
    if route in ("wide", "wide_f32", "wide_f32_few"):
        plan = wide_layout.plan(H, gates)
        wp = [wide_layout.pack_wh(w, plan) for w in ins["wh"]]
        tail = [T, B, H, plan.Hb, plan.U]
        if route == "wide":
            tail.append(0 if f32 else 1)
        else:
            tail.append(rows or (0 if route == "wide_f32_few" or B > 8 else 8))
        route = route.removesuffix("_few")
    else:
        plan = wide_mma_layout.plan(H, gates)
        tail = [T, B, H, plan.Hb, plan.U]
    route = _source_route(route)
    plan_fn = getattr(lib, f"percival_{kind}_bwd_{route}_plan")
    plan_fn.argtypes = [i] * (len(tail) - 1) + [ctypes.POINTER(ctypes.c_int)]
    plan_fn.restype = i
    out = (ctypes.c_int * 14)()  # the cluster BPTTs' plans have 9 fields, the streamed 14
    if plan_fn(*tail[1:], out):
        raise RuntimeError(f"{kind} {route}: no plan at B={B} H={H}")
    scratch = None
    if route == "wide_mma_stream":  # packed at the plan's chunk; the deep layout's scratch
        sp = wide_mma_layout.StreamPlan(*out)
        wp = [wide_mma_layout.pack_wh_stream(w, plan, sp.chunk) for w in ins["wh"]]
        if sp.scratch:
            scratch = torch.empty(2 * -(-B // sp.R) * sp.scratch, dtype=torch.uint8,
                                  device=ins["gx"][0].device)
    elif route == "wide_mma":
        wp = [wide_mma_layout.pack_wh(w, plan) for w in ins["wh"]]
    names = ["gx", "wp"] + (["hp", "cp", "c", "dy"] if kind == "bilstm" else ["bn", "hp", "dy"])
    tensors = {**ins, "wp": wp}
    ptrs = [t.data_ptr() for n in names for t in tensors[n]]
    ptrs += [t.data_ptr() for n in (["dgx"] if kind == "bilstm" else ["dgx", "dnr"])
             for t in outs[n]]
    if route == "wide_mma_stream":
        ptrs.append(None if scratch is None else scratch.data_ptr())
    fn = getattr(lib, f"percival_{kind}_bwd_{route}")
    fn.argtypes, fn.restype = [p] * len(ptrs) + [i] * len(tail) + [p], i

    def launch():
        err = fn(*ptrs, *tail, stream)
        if err:
            raise RuntimeError(f"{kind} {route}: CUDA error {err}")
    launch.keep = (wp, scratch)  # the packed W_h and the scratch live as long as the launcher
    launch.plan = list(out)
    return launch


def _plan_text(route: str, B: int, plan: list) -> str:
    """The launch plan of a cluster BPTT, as its ``*_plan`` function returns it."""
    if route == "wide":
        U, Hb, NC, KS, NT, R, w_smem, clusters, smem = plan[:9]
        waves = -(-2 * -(-B // R) // clusters)
        return (f"R={R}, W_h in {'shared memory' if w_smem else 'L2'}, {clusters} clusters at "
                f"once, {waves} waves, {smem} B")
    if route.startswith("wide_f32"):
        U, Hb, NC, R, nres, nstr, clusters, waves, smem = plan[:9]
        return (f"R={R}, {nres} resident / {nstr} streamed chunks, {clusters} clusters at once, "
                f"{waves} waves, {smem} B")
    if route.startswith("wide_mma_stream"):
        U, Hb, NC, R, nres, nstr, clusters, waves, dbuf, smem, chunk, ppw, scratch, ring = plan
        if ppw:
            return (f"R={R}, deep: {ppw} pairs a compute warp, {nstr} streamed chunks of {chunk} "
                    f"k through {ring} slots, {clusters} clusters at once, {waves} waves, {smem} "
                    f"B, {scratch} B of partials a cluster in L2")
        return (f"R={R}, {nres} resident / {nstr} streamed chunks, {clusters} clusters at once, "
                f"{waves} waves, {1 + dbuf} slot buffers, {smem} B")
    U, Hb, NC, R, MPW, clusters, waves, dbuf, smem = plan[:9]
    return f"R={R}, {clusters} clusters at once, {waves} waves, {smem} B"


def few_grid(libs, dev, g) -> None:
    """The few-row kernels' full step at each width of ``FEW_GRID``, every R
    that fits and B = R and 3·R (one and three clusters a direction, one
    wave), beside R·NC·H."""
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf

    for kind, widths in FEW_GRID.items():
        gates = 4 if kind == "bilstm" else 3
        for H in widths:
            for R in wf.FEW_ROWS:
                if not wf.few_fits(H, gates, R):
                    continue
                for B in (R, 3 * R):
                    ins, outs = _wide_inputs(kind, 512, B, H, dev, g, torch.float32)
                    launch = _wide_launcher(ctypes.CDLL(str(libs[(kind, "wide_f32_few", "full")])),
                                            kind, "wide_f32_few", 512, B, H, ins, outs, rows=R)
                    us = _time_ms(launch, launches=3) / 512 * 1e3
                    NC = wide_layout.plan(H, gates).NC
                    print(f"[few grid] {kind} H={H} R={R} B={B} (R·NC·H {R * NC * H}, "
                          f"{_plan_text('wide_f32', B, launch.plan)}): us a step {us:.3f}")


def wide_main(f32: bool = False, only: str = "", few: bool = False, grid: bool = False,
              stream: bool = False, deep: bool = False) -> int:
    """The cluster BPTTs' variants at ``WIDE_SHAPES`` (``few``: at
    ``FEW_SHAPES``; ``stream``: at ``STREAM_SHAPES``; ``deep``: at
    ``DEEP_SHAPES``): bf16 on ``"wide"`` and ``"wide_mma"`` (``stream``:
    ``"wide_mma_stream"``, which also runs ``no_stream``; ``deep``: the
    streamed kernels' deep layout alone, ``DEEP_VARIANTS``); with ``f32``,
    f32 on ``"wide"``, ``"wide_f32"`` (its chunked kernels, which also run
    ``no_stream``) and, with ``few``, ``"wide_f32_few"`` (the few-row
    kernels, ``FEW_VARIANTS``), each shape's plan printed first; ``only``:
    that route alone; ``grid`` (with ``few``): ``few_grid`` after them."""
    routes = ("wide", "wide_f32") + (("wide_f32_few",) if few else ()) if f32 else \
        ("wide_mma_stream_deep",) if deep else \
        ("wide", "wide_mma_stream" if stream else "wide_mma")
    routes = tuple(r for r in routes if not only or r == only)
    libs = _build_wide_variants(routes)
    dev = torch.device("cuda")
    dtype = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    for kind in ("bilstm", "bigru"):
        for T, B, H in (FEW_SHAPES[kind] if few else DEEP_SHAPES if deep else
                        STREAM_SHAPES if stream else WIDE_SHAPES):
            ins, outs = _wide_inputs(kind, T, B, H, dev, g, dtype)
            for route in routes:
                if (kind, route, "full") not in libs:
                    continue
                row, plan = [], None
                for name in _variants(route):
                    launch = _wide_launcher(ctypes.CDLL(str(libs[(kind, route, name)])), kind,
                                            route, T, B, H, ins, outs)
                    plan = plan or launch.plan
                    row.append(f"{name} {_time_ms(launch, launches=3) / T * 1e3:.3f}")
                print(f"[breakdown] {kind}_bwd_{route} T,B,H={(T, B, H)} {str(dtype)[6:]} "
                      f"({_plan_text(route, B, plan)}): us a step: " + ", ".join(row))
    if grid and "wide_f32_few" in routes:
        few_grid(libs, dev, g)
    return 0


DEEP_LINE = re.compile(r"\[breakdown\] (bilstm|bigru)_bwd_wide_mma_stream_deep T,B,H=\((\d+), "
                       r"(\d+), (\d+)\) bfloat16 \(R=(\d+), deep: .*?, (\d+) waves,.*?full ([\d.]+)")


def deep_fit(log: str) -> int:
    """The deep layout's step estimate (``wide_mma_layout.deep_step_ps``)
    fitted by least squares to the ``full`` steps of a ``--deep`` run's
    output ``log`` (a file): µs a step over the plan's waves against 1, the
    streamed packed rows (H / 32 · NC) and R·NC·H / 1024; prints the three
    constants in picoseconds and each point against its fit. Runs on the
    CPU."""
    rows = []
    for m in DEEP_LINE.finditer(open(log).read()):
        kind, T, B, H, R, waves, us = m.groups()
        H, R = int(H), int(R)
        NC = wide_mma_layout.plan(H, 4 if kind == "bilstm" else 3).NC
        rows.append((kind, int(B), H, R, [1.0, H // wide_mma_layout.DEEP_CHUNK * NC,
                                           R * NC * H // 1024], float(us) * 1e6 / int(waves)))
    if len(rows) < 3:
        print(f"bwd_step_breakdown: {len(rows)} deep steps in {log}, 3 needed", file=sys.stderr)
        return 2
    A = torch.tensor([r[4] for r in rows], dtype=torch.float64)
    y = torch.tensor([r[5] for r in rows], dtype=torch.float64)
    coef = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
    print("[deep fit] DEEP_STEP_PS, DEEP_ROW_PS, DEEP_MAC_PS = " +
          ", ".join(f"{round(c):_}" for c in coef.tolist()))
    for (kind, B, H, R, _, ps), fit in zip(rows, (A @ coef).tolist()):
        print(f"[deep fit] {kind} B={B} H={H} R={R}: ps a wave-step {ps:.0f}, fit {fit:.0f} "
              f"({fit / ps - 1:+.1%})")
    return 0


def main() -> int:
    fit = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--deep-fit=")), "")
    if fit:
        return deep_fit(fit)
    if not torch.cuda.is_available():
        print("bwd_step_breakdown: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    only = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")), "")
    if "--simt" in sys.argv[1:]:
        if "--f32" not in sys.argv[1:]:
            print("bwd_step_breakdown: --simt times the f32 kernels: add --f32", file=sys.stderr)
            return 2
        return simt_main(only)
    if "--wide" in sys.argv[1:]:
        return wide_main(f32="--f32" in sys.argv[1:], only=only, few="--few" in sys.argv[1:],
                         grid="--grid" in sys.argv[1:], stream="--stream" in sys.argv[1:],
                         deep="--deep" in sys.argv[1:])
    libs = _build_variants()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, gates in (("bilstm", 4), ("bigru", 3)):
        for T, B, H in SHAPES:
            pair = lambda *shape, s=1.0: [(torch.randn(*shape, generator=g, device=dev) * s).to(bf16)  # noqa: E731
                                          for _ in range(2)]
            gx = pair(T, B, gates * H)
            wh = pair(H, gates * H, s=H ** -0.5)
            wp = [pack_wh(w, kind[2:]) for w in wh]
            if kind == "bilstm":  # h_prev, c_prev, c, dy
                ins = gx + wh + wp + sum((pair(T, B, H, s=0.5) for _ in range(4)), [])
                outs = [torch.empty_like(x) for x in gx]
            else:  # b_hn, h_prev, dy
                ins = gx + wh + wp + pair(H) + pair(T, B, H, s=0.5) + pair(T, B, H, s=0.5)
                outs = [torch.empty_like(x) for x in gx] + [torch.empty(T, B, H, dtype=bf16, device=dev)
                                                            for _ in range(2)]
            ptrs = [t.data_ptr() for t in ins + outs]
            row = []
            for name in VARIANTS:
                lib = ctypes.CDLL(str(libs[(kind, name)]))
                fn = getattr(lib, f"percival_{kind}_bwd_mma")
                fn.argtypes, fn.restype = [p] * 16 + [i, i, i, p], i

                def launch():
                    err = fn(*ptrs, T, B, H, stream)
                    if err:
                        raise RuntimeError(f"{kind} {name}: CUDA error {err}")
                row.append(f"{name} {_time_ms(launch) / T * 1e3:.3f}")
            print(f"[breakdown] {kind}_bwd_mma T,B,H={(T, B, H)}: us a step: " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
