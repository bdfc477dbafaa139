"""Where a step of the tensor-core BPTT kernels goes, on the card.

    python -m percivaltts_tpu_torch.tools.bwd_step_breakdown

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

Times are medians of CUDA-event times over 20 launches; the card's name and
power limit are printed first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

from percivaltts_tpu_torch import _build
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_step_breakdown: needs an NVIDIA card", file=sys.stderr)
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
