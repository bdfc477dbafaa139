#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: build, check, serve,
train, time.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script exits 0 only when all
passed):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``percivaltts_tpu_torch/csrc`` (one nvcc per
   source, all at once, then one link);
3. hold the BiLSTM forward kernel against its plain PyTorch twin at the
   serving, edge and training shapes, f32 and bf16, with and without cells;
4. serve 8 requests (96…1500 frames) through ``eval/serve.py`` with the
   full-width config-3 generator (seeded init, numpy-made stats and labels):
   shapes, finiteness, one kernel launch per generator call, and agreement
   with the same requests served through the plain twin;
5. time the forward kernel and its twin at (T, B, H) = (512, 8, 128) bf16,
   and the 8 requests end to end;
6. hold the BPTT kernel against its twin at the training shape and edge
   shapes, f32 and bf16, and the autograd function pairing both kernels
   (dgx, dW_h) against the same function on the twins;
7. train at config-3 width: the fused WGAN-GP step (B=32, T=512,
   n_critic=5) from ``make_gan_state``, on raw padded batches made with
   numpy (utterances of 300–512 frames, so masks hold zeros) normalized on
   the device: 3 steps with finite metrics and exactly 2
   forward and 1 BPTT launches each; one step from identical state with
   the kernels against the same step with the plain twins;
8. time the BPTT kernel and its twin at (512, 32, 128) bf16, the WGAN step
   (median of 10), and profile one step for the device's busy share.

The line before the last is one JSON object describing each kernel of the
path; the last line is the JSON device record. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DEVICE = "cuda:0"
# serving and edge shapes, then the training path's: the fakes pass over
# n_critic·B rows (without cells) and the generator update (with cells)
KERNEL_SHAPES = [(512, 8, 128), (517, 3, 128), (64, 1, 128), (1536, 8, 128),
                 (512, 160, 128), (512, 32, 128)]
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

BWD_SHAPES = [(512, 32, 128), (517, 3, 128), (64, 1, 128), (33, 9, 64)]
# BPTT kernel vs twin. f32: absolute, as the forward. bf16: relative to
# max|dgx|, since dz is rounded to bf16 and fed back through dh, so a
# one-ulp flip is carried into earlier frames.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TIMED = (512, 32, 128)

TRAIN_B, TRAIN_T, LABEL_DIM = 32, 512, 425
UTT_FRAMES = (300, 512)  # utterance lengths: every batch pads, masks hold zeros
N_CHECKED_STEPS = 3
N_TIMED_STEPS = 10
# one bf16 step from identical state, kernels vs plain twins. The twins
# differ from the kernels by bf16 rounding flips in the f0 head; Adam's first
# step, lr·g/(|g| + eps), is sign-like, so a flip of a near-zero critic
# gradient moves that weight by up to 2·lr, which the generator update
# then reads. Metrics: relative to max(1, |value|); the generator's first
# moments (0.5·gradient): relative to each parameter's max|moment|. (Seen on
# an H100: metrics within 2.1e-6, moments within 5.8e-3.)
STEP_METRIC_TOL = 1e-3
STEP_MOMENT_TOL = 2e-2


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


def _bwd_args(T, B, H, dtype, device, seed):
    """The BPTT inputs from a forward pass of the plain twin: gx, W_h, the
    previous states (t−1 forward, t+1 backward), the cells and random dy."""
    from percivaltts_tpu_torch.ops.lstm_cuda import bilstm_fwd_reference

    gx_f, gx_b, wh_f, wh_b = _gates(T, B, H, dtype, device, seed)
    with torch.no_grad():
        yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
    z = torch.zeros_like(yf[:1])
    dy = np.random.default_rng(seed + 1).normal(size=(2, T, B, H)).astype(np.float32)
    dy = torch.from_numpy(dy).to(device=device, dtype=dtype)
    return (gx_f, gx_b, wh_f, wh_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, dy[0], dy[1])


def _check_bwd(dev) -> float:
    """Phase 6: the BPTT kernel and the autograd pair against the twins.
    Returns the largest bf16 |kernel − twin| of the BPTT kernel."""
    from percivaltts_tpu_torch.ops.lstm_cuda import (
        bilstm_bwd, bilstm_bwd_reference, bilstm_core, bilstm_core_reference,
        bilstm_fwd)

    max_err_bf16 = 0.0
    with torch.no_grad():
        for T, B, H in BWD_SHAPES:
            for dtype, tol in BWD_TOL.items():
                args = _bwd_args(T, B, H, dtype, dev, seed=T + B)
                want = bilstm_bwd_reference(*args)
                before = bilstm_bwd.launches
                got = bilstm_bwd(*args)
                torch.cuda.synchronize()
                if bilstm_bwd.launches != before + 1:
                    raise RuntimeError("bilstm_bwd did not count its launch")
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
                scale = max(w.float().abs().max().item() for w in want)
                limit = tol * scale if dtype == torch.bfloat16 else tol
                ok = all(g.shape == (T, B, 4 * H) and g.dtype == dtype for g in got)
                print(f"[bptt] T={T} B={B} H={H} {str(dtype)[6:]}: max|kernel-plain| = "
                      f"{err:.3g} (tol {limit:.3g}; max|dgx| {scale:.3g})")
                if not ok or not err <= limit:
                    raise AssertionError(f"bilstm_bwd disagrees at {(T, B, H, dtype)}")
                if dtype == torch.bfloat16:
                    max_err_bf16 = max(max_err_bf16, err)

    T, B, H = BWD_TIMED
    for dtype, tol in BWD_TOL.items():
        base = _gates(T, B, H, dtype, dev, seed=7)
        dy = [torch.randn((T, B, H), generator=torch.Generator(device=dev).manual_seed(s),
                          device=dev, dtype=dtype) for s in (1, 2)]
        grads = []
        for core in (bilstm_core, bilstm_core_reference):
            leaves = [t.clone().requires_grad_(True) for t in base]
            f0, b0 = bilstm_fwd.launches, bilstm_bwd.launches
            yf, yb = core(*leaves)
            torch.autograd.backward((yf, yb), dy)
            torch.cuda.synchronize()
            grads.append([t.grad for t in leaves])
            if core is bilstm_core and (bilstm_fwd.launches - f0, bilstm_bwd.launches - b0) != (1, 1):
                raise RuntimeError("the autograd pair did not launch one forward and one BPTT kernel")
        for name, g, w in zip(("dgx_f", "dgx_b", "dW_h_f", "dW_h_b"), *grads):
            err = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            limit = tol * scale if dtype == torch.bfloat16 else tol * max(1.0, scale)
            print(f"[autograd] {name} T,B,H={BWD_TIMED} {str(dtype)[6:]}: max|kernel-plain| = "
                  f"{err:.3g} (tol {limit:.3g}; max {scale:.3g})")
            if g.dtype != dtype or not err <= limit:
                raise AssertionError(f"the autograd pair disagrees on {name} ({dtype})")
    return max_err_bf16


def _train_setup(dev):
    """Config 3 at full width, WGAN-GP, with two sets of batches (5 critic
    batches + 1 generator batch each) on the device, raw, and the
    normalizing step."""
    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.eval.serve import NormStats
    from percivaltts_tpu_torch.training.ondevice import make_normalizing_step
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = Configuration(
        data=DataConfig(batch_size=TRAIN_B, bucket_bounds=(TRAIN_T,), label_dim=LABEL_DIM),
        vocoder=VocoderConfig(spec_size=65, nm_size=33),
        model=ModelConfig(generator="cnn_blstm"),
        train=TrainConfig(trainer="wgan", n_critic=5, seed=SEED),
    )
    nc, F = cfg.train.n_critic, cfg.vocoder.feature_size
    rng = np.random.default_rng(SEED + 10)
    # padded batches as the data pipeline gives them: utterances zero-padded
    # to the bound, mask 1 on their frames and 0 after
    batches = []
    for _ in range(2 * (nc + 1)):
        lengths = rng.integers(UTT_FRAMES[0], UTT_FRAMES[1] + 1, size=TRAIN_B)
        mask = (np.arange(TRAIN_T) < lengths[:, None]).astype(np.float32)
        lab = (rng.random((TRAIN_B, TRAIN_T, LABEL_DIM)) < 0.1).astype(np.float32)
        lab[..., -9:] = rng.random((TRAIN_B, TRAIN_T, 9)) * 10.0  # continuous positions
        cmp = (rng.normal(size=(TRAIN_B, TRAIN_T, F)) * 2.0 + 1.0).astype(np.float32)
        batch = {"lab": lab * mask[..., None], "cmp": cmp * mask[..., None], "mask": mask}
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    if not all(b["mask"].min() == 0 for b in batches):
        raise AssertionError("the smoke batches are not all padded")
    sets = []
    for i in range(2):
        group = batches[i * (nc + 1):(i + 1) * (nc + 1)]
        critic = {k: torch.stack([b[k] for b in group[:nc]]) for k in group[0]}
        sets.append((critic, group[nc]))
    in_stats = NormStats(shift=np.full(LABEL_DIM, 0.1, np.float32),
                         scale=rng.uniform(0.5, 2.0, LABEL_DIM).astype(np.float32))
    out_stats = NormStats(shift=np.ones(F, np.float32), scale=np.full(F, 0.5, np.float32))
    step = make_normalizing_step(make_wgan_step(cfg.train), in_stats, out_stats, dev)
    return cfg, sets, step


def _busy_share(prof, wall_ms: float):
    """(device busy ms as the union of device event intervals, share of
    ``wall_ms``, [(kernel name, device ms, count)] largest first) from a
    torch.profiler run; None when the trace holds no device events."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy = (busy + hi - lo) / 1e3
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda t: -t[1])
    return busy, busy / wall_ms, top


def _train(dev) -> dict:
    """Phases 7 and 8. Returns the launch counts of the checked steps and
    the timings."""
    from percivaltts_tpu_torch.ops.lstm_cuda import (
        bilstm_bwd, bilstm_bwd_reference, bilstm_core_reference, bilstm_fwd)
    from percivaltts_tpu_torch.training.state import make_gan_state

    cfg, sets, step = _train_setup(dev)
    nc = cfg.train.n_critic
    state = make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev)

    bilstm_fwd.launches = 0
    bilstm_bwd.launches = 0
    for s in range(N_CHECKED_STEPS):
        f0, b0 = bilstm_fwd.launches, bilstm_bwd.launches
        state, m = step(state, *sets[s % 2])
        torch.cuda.synchronize()
        vals = {k: v.item() for k, v in m.items()}
        launched = (bilstm_fwd.launches - f0, bilstm_bwd.launches - b0)
        print(f"[train] step {s}: " + " ".join(f"{k} {v:.6g}" for k, v in vals.items())
              + f"; launches fwd {launched[0]} bptt {launched[1]}")
        if launched != (2, 1):
            raise AssertionError(f"a WGAN step launched {launched}, not 2 forward and 1 BPTT")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics at step {s}: {vals}")
    counts = {"fwd": bilstm_fwd.launches, "bwd": bilstm_bwd.launches}
    if not all(torch.isfinite(p).all() for p in state.gen.parameters()):
        raise AssertionError("non-finite generator parameters after training")

    # one step from identical state: kernels vs plain twins (launches of
    # this comparison are not counted above)
    eps = torch.rand((nc, TRAIN_B, 1, 1), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    ref = {}
    for name in ("kernel", "plain"):
        st = make_gan_state(cfg, LABEL_DIM, seed=SEED, device=dev)
        if name == "plain":
            st.gen.f0_blstm.core = bilstm_core_reference
        st, m = step(st, *sets[0], eps=eps)
        torch.cuda.synchronize()
        ref[name] = ({k: v.item() for k, v in m.items()},
                     {n: st.gen_opt.state[p]["exp_avg"] for n, p in st.gen.named_parameters()})
    (mk, ek), (mp, ep) = ref["kernel"], ref["plain"]
    for k in mk:
        err = abs(mk[k] - mp[k])
        limit = STEP_METRIC_TOL * max(1.0, abs(mp[k]))
        print(f"[train] kernel vs plain step, {k}: {mk[k]:.6g} vs {mp[k]:.6g} (|diff| {err:.3g}, tol {limit:.3g})")
        if not err <= limit:
            raise AssertionError(f"the kernel step disagrees with the plain step on {k}")
    worst = max(((ek[n] - ep[n]).abs().max().item() / max(ep[n].abs().max().item(), 1e-30), n)
                for n in ek)
    print(f"[train] kernel vs plain step, generator exp_avg: worst relative |diff| "
          f"{worst[0]:.3g} ({worst[1]}; tol {STEP_MOMENT_TOL:g}); f0_blstm: " + ", ".join(
              f"{n} {(ek[n] - ep[n]).abs().max().item() / ep[n].abs().max().item():.3g}"
              for n in ek if n.startswith("f0_blstm")))
    if not worst[0] <= STEP_MOMENT_TOL:
        raise AssertionError("the kernel step's Adam moments disagree with the plain step's")

    # timing
    T, B, H = BWD_TIMED
    args = _bwd_args(T, B, H, torch.bfloat16, dev, seed=SEED)
    fwd_args = {b: _gates(T, b, H, torch.bfloat16, dev, seed=1) for b in (B, nc * B)}
    with torch.no_grad():
        bwd_ms = _median_ms(lambda: bilstm_bwd(*args), runs=7, inner=10)
        bwd_plain_ms = _median_ms(lambda: bilstm_bwd_reference(*args), runs=3)
        fwd_ms = {b: _median_ms(lambda: bilstm_fwd(*a, with_cells=True), runs=5, inner=10)
                  for b, a in fwd_args.items()}
    print(f"[time] bilstm_bwd T,B,H={BWD_TIMED} bf16: kernel {bwd_ms:.4f} ms, plain twin "
          f"{bwd_plain_ms:.4f} ms (median, CUDA events)")
    print(f"[time] bilstm_fwd with cells, T={T} H={H} bf16: " + ", ".join(
        f"B={b} {ms:.4f} ms" for b, ms in fwd_ms.items()) + " (median, CUDA events)")
    for i in range(2):  # warm-up
        state, _ = step(state, *sets[i])
    times = []
    for i in range(N_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, *sets[i % 2])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    frames = TRAIN_B * TRAIN_T * (nc + 1)
    print(f"[time] WGAN-GP step config 3 (B={TRAIN_B}, T={TRAIN_T}, n_critic={nc}): median "
          f"{step_ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}, {N_TIMED_STEPS} steps), "
          f"{frames / step_ms * 1e3:.1f} frames/s")
    print(f"[time] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, *sets[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    share = _busy_share(prof, wall)
    if share is None:
        print(f"[profile] one step {wall:.3f} ms wall; the trace holds no device events: "
              "busy share not measured")
    else:
        busy, frac, top = share
        lstm = [t for t in top if "bilstm" in t[0]]
        print(f"[profile] one step {wall:.3f} ms wall (profiled), device busy {busy:.3f} ms, "
              f"busy share {frac:.3f}; {sum(n for *_, n in top)} device events; BiLSTM "
              f"kernels {sum(ms for _, ms, _ in lstm):.3f} ms")
        for key, ms, count in top[:12]:
            print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    return {"counts": counts, "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
            "step_ms": step_ms}


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

    core = gen.f0_blstm.core
    gen.f0_blstm.core = bilstm_fwd_reference
    plain = serve(gen, labs, in_stats, out_stats)
    gen.f0_blstm.core = core
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

    # 6. the BPTT kernel and the autograd pair
    bwd_err_bf16 = _check_bwd(dev)

    # 7–8. training at config-3 width, and its timings
    train = _train(dev)

    print(json.dumps({"kernels": [
        {
            "name": "bilstm_fwd",
            "route": "cuda",
            "source": "percivaltts_tpu_torch/csrc/bilstm_fwd.cu",
            "replaces": "percivaltts_tpu/ops/lstm_pallas.py:145",
            "launches": launches + train["counts"]["fwd"],
            "launches_by_path": {"serve": launches, "train": train["counts"]["fwd"]},
            "max_abs_err": max_err_bf16,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "bilstm_bwd",
            "route": "cuda",
            "source": "percivaltts_tpu_torch/csrc/bilstm_bwd.cu",
            "replaces": "percivaltts_tpu/ops/lstm_pallas.py:233",
            "launches": train["counts"]["bwd"],
            "launches_by_path": {"train": train["counts"]["bwd"]},
            "max_abs_err": bwd_err_bf16,
            "ms": train["bwd_ms"],
            "plain_ms": train["bwd_plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
