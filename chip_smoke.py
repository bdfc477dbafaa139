#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: build, check, serve, time.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script exits 0 only when all
passed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``percivaltts_tpu_torch/csrc`` (nvcc);
3. hold the BiLSTM kernel against its plain PyTorch twin at the serving and
   edge shapes, f32 and bf16, with and without cells;
4. serve 8 requests (96…1500 frames) through ``eval/serve.py`` with the
   full-width config-3 generator (seeded init, numpy-made stats and labels):
   shapes, finiteness, one kernel launch per generator call, and agreement
   with the same requests served through the plain twin;
5. time the kernel and its twin at (T, B, H) = (512, 8, 128) bf16, and the
   8 requests end to end.

The line before the last is one JSON object describing each kernel of the
path; the last line is the JSON device record. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DEVICE = "cuda:0"
KERNEL_SHAPES = [(512, 8, 128), (517, 3, 128), (64, 1, 128), (1536, 8, 128)]
# f32: the same math with sums and transcendentals in another order.
# bf16: outputs are bf16 (ulp 2^-8 near 1) and h is rounded to bf16 before
# each product, so a one-ulp rounding flip is carried into later steps.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REQUEST_LENGTHS = (96, 137, 250, 400, 512, 777, 1024, 1500)
# kernel vs plain twin through the whole generator, bf16, denormalized: only
# the f0 stream reads the BiLSTM; a few bf16 ulps at |f0| < 2, divided by
# output scales >= 0.5
SERVE_TOL = 0.0625
TIMED_SHAPE = (512, 8, 128)


def _median_ms(fn, runs: int, inner: int = 1) -> float:
    """Median over ``runs`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _gates(T, B, H, dtype, device, seed):
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(2, T, B, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
    return to(gx[0]), to(gx[1]), to(wh[0]), to(wh[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from percivaltts_tpu_torch import ModelConfig, VocoderConfig, _build
    from percivaltts_tpu_torch.eval.serve import NormStats, serve
    from percivaltts_tpu_torch.models import build_generator, count_params
    from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_fwd, bilstm_fwd_reference

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    built = _build.build(force=True)
    print(f"[build] {built.path.name} from {len(_build.sources())} source(s) in "
          f"{built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # 3. kernel vs plain twin
    max_err_bf16 = 0.0
    with torch.no_grad():
        for T, B, H in KERNEL_SHAPES:
            for dtype, tol in KERNEL_TOL.items():
                args = _gates(T, B, H, dtype, dev, seed=T + B)
                want = bilstm_fwd_reference(*args, with_cells=True)
                for cells in (False, True):
                    before = bilstm_fwd.launches
                    got = bilstm_fwd(*args, with_cells=cells)
                    torch.cuda.synchronize()
                    if bilstm_fwd.launches != before + 1:
                        raise RuntimeError("bilstm_fwd did not count its launch")
                    err = max(
                        (g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)
                    )
                    ok = all(g.shape == (T, B, H) and g.dtype == dtype for g in got)
                    print(f"[kernel] T={T} B={B} H={H} {str(dtype)[6:]} cells={cells}: "
                          f"max|kernel-plain| = {err:.3g} (tol {tol:g})")
                    if not ok or not err <= tol:
                        raise AssertionError(f"bilstm_fwd disagrees at {(T, B, H, dtype, cells)}")
                    if dtype == torch.bfloat16:
                        max_err_bf16 = max(max_err_bf16, err)

    # 4. serve 8 requests at full config-3 width
    model_cfg, voc, label_dim = ModelConfig(generator="cnn_blstm"), VocoderConfig(), 425
    gen = build_generator(model_cfg, voc, label_dim,
                          generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    n_params = count_params(gen)
    if n_params != 3_246_691:
        raise AssertionError(f"config 3 has 3,246,691 parameters, built {n_params}")
    rng = np.random.default_rng(SEED)
    labs = []
    for n in REQUEST_LENGTHS:  # binary question answers + continuous positions
        lab = (rng.random((n, label_dim)) < 0.1).astype(np.float32)
        lab[:, -9:] = rng.random((n, 9)) * 10.0
        labs.append(lab)
    in_stats = NormStats(shift=np.full(label_dim, 0.1, np.float32),
                         scale=rng.uniform(0.5, 2.0, label_dim).astype(np.float32))
    out_stats = NormStats(shift=rng.normal(size=voc.feature_size).astype(np.float32),
                          scale=rng.uniform(0.5, 2.0, voc.feature_size).astype(np.float32))
    calls = [0]
    gen.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))

    bilstm_fwd.launches = 0
    calls[0] = 0
    feats = serve(gen, labs, in_stats, out_stats)
    launches, gen_calls = bilstm_fwd.launches, calls[0]
    print(f"[serve] {len(labs)} requests, {gen_calls} generator calls, "
          f"{launches} bilstm_fwd launches")
    if not (launches > 0 and launches == gen_calls):
        raise AssertionError(f"{launches} kernel launches for {gen_calls} generator calls")
    for n, f in zip(REQUEST_LENGTHS, feats):
        if f.shape != (n, voc.feature_size) or f.dtype != np.float32 or not np.isfinite(f).all():
            raise AssertionError(f"bad features for a {n}-frame request: {f.shape} {f.dtype}")

    gen.f0_blstm.core = bilstm_fwd_reference
    plain = serve(gen, labs, in_stats, out_stats)
    gen.f0_blstm.core = bilstm_fwd
    serve_err = max(np.abs(a - b).max() for a, b in zip(feats, plain))
    print(f"[serve] max|kernel-plain| over all features = {serve_err:.3g} (tol {SERVE_TOL:g})")
    if not serve_err <= SERVE_TOL:
        raise AssertionError("served features disagree with the plain twin")

    # 5. timing
    args = _gates(*TIMED_SHAPE, torch.bfloat16, dev, seed=SEED)
    with torch.no_grad():
        kernel_ms = _median_ms(lambda: bilstm_fwd(*args), runs=7, inner=20)
        plain_ms = _median_ms(lambda: bilstm_fwd_reference(*args), runs=5)
    print(f"[time] bilstm_fwd T,B,H={TIMED_SHAPE} bf16: kernel {kernel_ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms (median, CUDA events)")
    serve(gen, labs, in_stats, out_stats)  # warm-up
    lat = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(gen, labs, in_stats, out_stats)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    med = statistics.median(lat)
    frames = sum(REQUEST_LENGTHS)
    print(f"[time] serve 8 requests ({frames} frames): median {med * 1e3:.3f} ms "
          f"(min {min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f}), {frames / med:.0f} frames/s")

    print(json.dumps({"kernels": [{
        "name": "bilstm_fwd",
        "route": "cuda",
        "source": "percivaltts_tpu_torch/csrc/bilstm_fwd.cu",
        "replaces": "percivaltts_tpu/ops/lstm_pallas.py:145",
        "launches": launches,
        "max_abs_err": max_err_bf16,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
