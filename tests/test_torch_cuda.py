"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.) The forward and
BPTT kernels have four routes each, chosen from dtype and width: bf16 with
H a multiple of 16 up to 128 takes the tensor-core kernels
(``csrc/{bilstm,bigru}_{fwd,bwd}_mma.cu``); bf16 past 128 up to H = 608
(LSTM) / 672 (GRU) the tensor-core cluster kernels
(``csrc/{bilstm,bigru}_{fwd,bwd}_wide_mma.cu``); f32 past H = 512 and
wider bf16 the CUDA-core cluster kernels
(``csrc/{bilstm,bigru}_{fwd,bwd}_wide.cu``, up to H = 4096); other widths
the one-block CUDA-core ones (``csrc/{bilstm,bigru}_{fwd,bwd}.cu``, whose
BPTTs run H that is not a multiple of 8 / 32 zero-padded to one); f32 has
its own cluster kernels, ``csrc/{bilstm,bigru}_{fwd,bwd}_wide_f32.cu`` past
the one-block widths (LSTM 256, GRU 320) up to 512 and
``csrc/{bilstm,bigru}_{fwd,bwd}_narrow_f32.cu`` at them (``-k "wide_f32 or
narrow_f32"``); the tests pick a route by the dtype and H they pass and
check it by the wrappers' ``.routes``.
Tolerances, the same for the BiLSTM and the BiGRU kernels: f32 1e-4 (sums
and transcendentals in another order); bf16 2e-2 (bf16 outputs, and h
rounded to bf16 before each product, so a one-ulp flip is carried); for the BPTT
kernels in bf16, 2e-2 of max|dgx| (or max|dnr|: the d(gates) are rounded to
bf16 and fed back through dh). The DSP kernels (framing × window,
overlap-add) equal their twins bit for bit in f32 and bf16.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops.gru_cuda import (
    bigru,
    bigru_bwd,
    bigru_bwd_reference,
    bigru_core,
    bigru_core_reference,
    bigru_fwd,
    bigru_fwd_reference,
)
from percivaltts_tpu_torch.ops.lstm_cuda import (
    bilstm,
    bilstm_bwd,
    bilstm_bwd_reference,
    bilstm_core,
    bilstm_core_reference,
    bilstm_fwd,
    bilstm_fwd_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gates(T, B, H, dtype, device, seed):
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(2, T, B, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in (*gx, *wh)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(64, 1, 128), (517, 3, 128), (33, 9, 64), (40, 160, 128)])
def test_kernel_matches_reference(cuda_device, dtype, atol, T, B, H):
    args = _gates(T, B, H, dtype, cuda_device, seed=T + B)
    before = bilstm_fwd.launches
    with torch.no_grad():
        got = bilstm_fwd(*args, with_cells=True)
        want = bilstm_fwd_reference(*args, with_cells=True)
    torch.cuda.synchronize()
    assert bilstm_fwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (T, B, H)
        assert (g.float() - w.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_bilstm_layer_matches_plain_twin(cuda_device):
    rng = np.random.default_rng(0)
    B, T, D, H = 2, 70, 24, 32
    x, wi_f, wi_b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
                     for s in ((B, T, D), (D, 4 * H), (D, 4 * H)))
    _, _, wh_f, wh_b = _gates(1, 1, H, torch.float32, cuda_device, seed=1)
    b_f, b_b = torch.zeros(4 * H, device=cuda_device), torch.ones(4 * H, device=cuda_device)
    with torch.no_grad():
        got = bilstm(x, wi_f, wh_f, b_f, wi_b, wh_b, b_b)
        want = bilstm(x, wi_f, wh_f, b_f, wi_b, wh_b, b_b, core=bilstm_fwd_reference)
    assert got.shape == (B, T, 2 * H)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_grad_mixed_devices_strides_and_width(cuda_device):
    args = _gates(4, 2, 32, torch.float32, cuda_device, seed=2)
    with pytest.raises(ValueError):
        bilstm_fwd(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):
        bilstm_fwd(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    # past H = 256 a cluster kernel runs (in f32 up to 512 the f32 one), the
    # CUDA-core one up to its limit of 4096
    wide = _gates(2, 1, 264, torch.float32, cuda_device, seed=3)
    r0 = bilstm_fwd.routes["wide_f32"]
    with torch.no_grad():
        _close(bilstm_fwd(*wide), bilstm_fwd_reference(*wide), 1e-4)
    assert bilstm_fwd.routes["wide_f32"] == r0 + 1
    with pytest.raises(ValueError, match="H <= 4096"):
        bilstm_fwd(*_gates(1, 1, 4097, torch.bfloat16, cuda_device, seed=3))
    args[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="bilstm_core"):
        bilstm_fwd(*args)
    with torch.no_grad():
        bilstm_fwd(*args)  # no graph wanted: the kernel runs


def _bwd_args(T, B, H, dtype, device, seed):
    gx_f, gx_b, wh_f, wh_b = _gates(T, B, H, dtype, device, seed)
    with torch.no_grad():
        yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
    z = torch.zeros_like(yf[:1])
    dy = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, T, B, H)).astype(np.float32))
    dy = dy.to(device=device, dtype=dtype)
    return [gx_f, gx_b, wh_f, wh_b, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]),
            torch.cat([z, cf[:-1]]), torch.cat([cb[1:], z]), cf, cb, dy[0], dy[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(512, 32, 128), (517, 3, 128), (64, 1, 128), (33, 9, 64),
                                   (40, 160, 128)])
def test_bwd_kernel_matches_reference(cuda_device, dtype, T, B, H):
    args = _bwd_args(T, B, H, dtype, cuda_device, seed=T + B)
    before = bilstm_bwd.launches
    got = bilstm_bwd(*args)
    want = bilstm_bwd_reference(*args)
    torch.cuda.synchronize()
    assert bilstm_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (T, B, 4 * H)
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= (2e-2 * scale if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_pair_matches_twins_and_counts_launches(cuda_device, dtype):
    base = _gates(96, 6, 64, dtype, cuda_device, seed=11)
    dy = _bwd_args(96, 6, 64, dtype, cuda_device, seed=12)[-2:]
    # f32: the forward and the BPTT on their f32 narrow kernels
    route = "mma" if dtype == torch.bfloat16 else "narrow_f32"
    broute = "mma" if dtype == torch.bfloat16 else "narrow_f32"
    grads = []
    for core in (bilstm_core, bilstm_core_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        f0, b0, r0 = bilstm_fwd.launches, bilstm_bwd.launches, bilstm_fwd.routes[route]
        rb = bilstm_bwd.routes[broute]
        yf, yb = core(*leaves)
        torch.autograd.backward((yf, yb), dy)
        torch.cuda.synchronize()
        launched = (bilstm_fwd.launches - f0, bilstm_bwd.launches - b0)
        assert launched == ((1, 1) if core is bilstm_core else (0, 0))
        assert (bilstm_fwd.routes[route] - r0, bilstm_bwd.routes[broute] - rb) == launched
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        scale = w.float().abs().max().item()
        tol = 2e-2 * scale if dtype == torch.bfloat16 else 1e-4 * max(1.0, scale)
        assert g.dtype == dtype and (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_bwd_kernel_refuses_strides_dtypes_shapes_grad_and_width(cuda_device):
    args = _bwd_args(8, 2, 32, torch.float32, cuda_device, seed=3)
    bad_stride = args[:10] + [args[10].transpose(0, 1).contiguous().transpose(0, 1), args[11]]
    with pytest.raises(ValueError, match="contiguous"):
        bilstm_bwd(*bad_stride)
    with pytest.raises(TypeError):
        bilstm_bwd(*args[:11], args[11].to(torch.bfloat16))
    with pytest.raises(ValueError):
        bilstm_bwd(*args[:4], args[4][:-1], *args[5:])
    with pytest.raises(ValueError):
        bilstm_bwd(*args[:11], args[11].cpu())
    # H not a multiple of 8: zero-padded to one, the twin's result
    odd = _bwd_args(4, 1, 12, torch.float32, cuda_device, seed=4)
    _close(bilstm_bwd(*odd), bilstm_bwd_reference(*odd), 1e-4)
    with pytest.raises(ValueError, match="H <= 4096"):
        bilstm_bwd(*_bwd_args(1, 1, 4097, torch.bfloat16, cuda_device, seed=4))
    args[11] = args[11].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="bilstm_core"):
        bilstm_bwd(*args)


@pytest.mark.cuda
def test_wgan_step_on_the_card_launches_the_kernel_pair(cuda_device):
    """One fused WGAN-GP step at small width on the card: finite metrics,
    two forward launches (the fakes pass, the generator update) and one
    BPTT launch."""
    import dataclasses

    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = Configuration(
        data=DataConfig(batch_size=4, bucket_bounds=(64,), label_dim=13),
        vocoder=VocoderConfig(spec_size=17, nm_size=9),
        model=dataclasses.replace(ModelConfig(generator="cnn_blstm"), hidden_size=32,
                                  blstm_size=64, critic_hidden=32, critic_blocks=2),
        train=TrainConfig(n_critic=2),
    )
    state = make_gan_state(cfg, 13, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    batch = lambda *lead: {  # noqa: E731
        "lab": torch.randn(*lead, 4, 64, 13, generator=g, device=cuda_device),
        "cmp": torch.randn(*lead, 4, 64, 27, generator=g, device=cuda_device),
        "mask": torch.ones(*lead, 4, 64, device=cuda_device),
    }
    f0, b0, r0 = bilstm_fwd.launches, bilstm_bwd.launches, bilstm_fwd.routes["mma"]
    rb = bilstm_bwd.routes["mma"]
    state, m = make_wgan_step(cfg.train)(state, batch(2), batch())
    torch.cuda.synchronize()
    assert (bilstm_fwd.launches - f0, bilstm_bwd.launches - b0) == (2, 1)
    # bf16, H=32: the tensor-core forward and BPTT
    assert (bilstm_fwd.routes["mma"] - r0, bilstm_bwd.routes["mma"] - rb) == (2, 1)
    assert all(torch.isfinite(v).item() for v in m.values())


# --- the BiGRU kernels --------------------------------------------------------


def _gru_gates(T, B, H, dtype, device, seed):
    """gx_f, gx_b (T, B, 3H), W_h (H, 3H) and b_hn (H,) per direction."""
    rng = np.random.default_rng(seed)
    arrays = (*rng.normal(size=(2, T, B, 3 * H)), *(rng.normal(size=(2, H, 3 * H)) / np.sqrt(H)),
              *rng.normal(size=(2, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype) for a in arrays]


def _gru_bwd_args(T, B, H, dtype, device, seed):
    """The BPTT inputs: h_prev from the twin's forward outputs, random dy."""
    args = _gru_gates(T, B, H, dtype, device, seed)
    with torch.no_grad():
        yf, yb = bigru_fwd_reference(*args)
    z = torch.zeros_like(yf[:1])
    dy = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(2, T, B, H)).astype(np.float32))
    dy = dy.to(device=device, dtype=dtype)
    return [*args, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), dy[0], dy[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(64, 1, 128), (517, 3, 128), (33, 9, 64), (40, 160, 128),
                                   (40, 32, 128), (20, 5, 40)])
def test_gru_kernel_matches_reference(cuda_device, dtype, atol, T, B, H):
    args = _gru_gates(T, B, H, dtype, cuda_device, seed=T + B)
    before = bigru_fwd.launches
    with torch.no_grad():
        got = bigru_fwd(*args)
        want = bigru_fwd_reference(*args)
    torch.cuda.synchronize()
    assert bigru_fwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (T, B, H)
        assert (g.float() - w.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(512, 32, 128), (517, 3, 128), (64, 1, 128), (33, 9, 64),
                                   (40, 160, 128)])
def test_gru_bwd_kernel_matches_reference(cuda_device, dtype, T, B, H):
    args = _gru_bwd_args(T, B, H, dtype, cuda_device, seed=T + B)
    before = bigru_bwd.launches
    with torch.no_grad():
        got = bigru_bwd(*args)
        want = bigru_bwd_reference(*args)
    torch.cuda.synchronize()
    assert bigru_bwd.launches == before + 1
    for g, w, width in zip(got, want, (3 * H, 3 * H, H, H)):
        assert g.dtype == dtype and g.shape == (T, B, width)
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= (2e-2 * scale if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_autograd_pair_matches_twins_and_counts_launches(cuda_device, dtype):
    """dgx, dW_h and db_hn of the kernel pair against the twins'."""
    base = _gru_gates(96, 6, 64, dtype, cuda_device, seed=11)
    dy = _gru_bwd_args(96, 6, 64, dtype, cuda_device, seed=12)[-2:]
    # f32: the forward and the BPTT on their f32 narrow kernels
    route = "mma" if dtype == torch.bfloat16 else "narrow_f32"
    broute = "mma" if dtype == torch.bfloat16 else "narrow_f32"
    grads = []
    for core in (bigru_core, bigru_core_reference):
        leaves = [t.clone().requires_grad_(True) for t in base]
        f0, b0, r0 = bigru_fwd.launches, bigru_bwd.launches, bigru_fwd.routes[route]
        rb = bigru_bwd.routes[broute]
        yf, yb = core(*leaves)
        torch.autograd.backward((yf, yb), dy)
        torch.cuda.synchronize()
        launched = (bigru_fwd.launches - f0, bigru_bwd.launches - b0)
        assert launched == ((1, 1) if core is bigru_core else (0, 0))
        assert (bigru_fwd.routes[route] - r0, bigru_bwd.routes[broute] - rb) == launched
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        scale = w.float().abs().max().item()
        tol = 2e-2 * scale if dtype == torch.bfloat16 else 1e-4 * max(1.0, scale)
        assert g.dtype == dtype and (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_bigru_layer_matches_plain_twin(cuda_device):
    rng = np.random.default_rng(0)
    B, T, D, H = 2, 70, 24, 32
    x, wi_f, wi_b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
                     for s in ((B, T, D), (D, 3 * H), (D, 3 * H)))
    _, _, wh_f, wh_b, bn_f, bn_b = _gru_gates(1, 1, H, torch.float32, cuda_device, seed=1)
    b_f, b_b = torch.zeros(3 * H, device=cuda_device), torch.ones(3 * H, device=cuda_device)
    with torch.no_grad():
        got = bigru(x, wi_f, wh_f, b_f, bn_f, wi_b, wh_b, b_b, bn_b)
        want = bigru(x, wi_f, wh_f, b_f, bn_f, wi_b, wh_b, b_b, bn_b, core=bigru_fwd_reference)
    assert got.shape == (B, T, 2 * H)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_gru_kernels_refuse_strides_devices_grad_and_width(cuda_device):
    args = _gru_bwd_args(8, 2, 32, torch.float32, cuda_device, seed=3)
    fwd_args = args[:6]
    with pytest.raises(ValueError):
        bigru_fwd(fwd_args[0].cpu(), *fwd_args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        bigru_fwd(fwd_args[0].transpose(0, 1).contiguous().transpose(0, 1), *fwd_args[1:])
    # past the one-block kernels' widths the cluster kernels run, up to the
    # wide route's own limit, which the refusal names
    from percivaltts_tpu_torch.ops.wide_layout import GRU_MAX_H

    wide = _gru_gates(2, 1, 344, torch.float32, cuda_device, seed=4)
    with torch.no_grad():
        _close(bigru_fwd(*wide), bigru_fwd_reference(*wide), 1e-4)
    H = GRU_MAX_H + 1
    big = [torch.zeros(s, device=cuda_device) for s in
           [(2, 1, 3 * H)] * 2 + [(H, 3 * H)] * 2 + [(H,)] * 2 + [(2, 1, H)] * 4]
    with pytest.raises(ValueError, match=f"H <= {GRU_MAX_H}"):
        bigru_fwd(*big[:6])
    # the BPTT runs H that is not a multiple of 32 zero-padded to one, up to
    # 320, and the cluster kernel past it
    odd = _gru_bwd_args(4, 1, 40, torch.float32, cuda_device, seed=4)
    _close(bigru_bwd(*odd), bigru_bwd_reference(*odd), 1e-4)
    wide = _gru_bwd_args(4, 1, 330, torch.float32, cuda_device, seed=4)
    _close(bigru_bwd(*wide), bigru_bwd_reference(*wide), 1e-4)
    with pytest.raises(ValueError, match=f"H <= {GRU_MAX_H}"):
        bigru_bwd(*big)
    with pytest.raises(ValueError, match="contiguous"):
        bigru_bwd(*args[:9], args[9].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError):
        bigru_bwd(*args[:9], args[9].to(torch.bfloat16))
    fwd_args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="bigru_core"):
        bigru_fwd(*fwd_args)
    with pytest.raises(RuntimeError, match="bigru_core"):
        bigru_bwd(*args)
    with torch.no_grad():
        bigru_fwd(*fwd_args)  # no graph wanted: the kernel runs


@pytest.mark.cuda
def test_bgru_wgan_step_on_the_card_launches_the_gru_kernels(cuda_device):
    """One fused WGAN-GP step with a small BGRU generator on the card: finite
    metrics, four forward launches (2 layers x the fakes pass and the
    generator update) and two BPTT launches (one per layer)."""
    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = Configuration(
        data=DataConfig(batch_size=4, bucket_bounds=(64,), label_dim=13),
        vocoder=VocoderConfig(spec_size=17, nm_size=9),
        model=ModelConfig(generator="bgru", blstm_size=64, critic_hidden=32, critic_blocks=2),
        train=TrainConfig(n_critic=2),
    )
    state = make_gan_state(cfg, 13, seed=0)  # the card by default
    assert next(state.gen.parameters()).is_cuda
    g = torch.Generator(device=cuda_device).manual_seed(0)
    batch = lambda *lead: {  # noqa: E731
        "lab": torch.randn(*lead, 4, 64, 13, generator=g, device=cuda_device),
        "cmp": torch.randn(*lead, 4, 64, 27, generator=g, device=cuda_device),
        "mask": torch.ones(*lead, 4, 64, device=cuda_device),
    }
    f0, b0, r0 = bigru_fwd.launches, bigru_bwd.launches, bigru_fwd.routes["mma"]
    rb = bigru_bwd.routes["mma"]
    state, m = make_wgan_step(cfg.train)(state, batch(2), batch())
    torch.cuda.synchronize()
    assert (bigru_fwd.launches - f0, bigru_bwd.launches - b0) == (4, 2)
    # bf16, H a multiple of 16: the tensor-core forward and BPTT
    assert (bigru_fwd.routes["mma"] - r0, bigru_bwd.routes["mma"] - rb) == (4, 2)
    assert all(torch.isfinite(v).item() for v in m.values())


# --- the two forward routes ---------------------------------------------------

# the serving chunk (B=8), edge shapes, the narrow width, and the training
# shapes (the fakes pass at n_critic·B = 160 rows)
MMA_SHAPES = [(1, 1, 128), (64, 1, 128), (517, 3, 128), (512, 8, 128), (33, 9, 64),
              (40, 160, 128), (512, 160, 128)]


def _routes():
    return dict(bilstm_fwd.routes), dict(bigru_fwd.routes)


def _close(got, want, atol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", MMA_SHAPES)
def test_tensor_core_forwards_match_twins(cuda_device, T, B, H):
    """bf16, H a multiple of 16 up to 128: both forwards launch the
    tensor-core kernels and agree with the twins within 2e-2."""
    bf16 = torch.bfloat16
    lstm_args = _gates(T, B, H, bf16, cuda_device, seed=T + B)
    gru_args = _gru_gates(T, B, H, bf16, cuda_device, seed=T + B)
    (l0, g0) = _routes()
    with torch.no_grad():
        want = bilstm_fwd_reference(*lstm_args, with_cells=True)
        _close(bilstm_fwd(*lstm_args, with_cells=True), want, 2e-2)
        _close(bilstm_fwd(*lstm_args), want[:2], 2e-2)
        _close(bigru_fwd(*gru_args), bigru_fwd_reference(*gru_args), 2e-2)
    torch.cuda.synchronize()
    l1, g1 = _routes()
    assert (l1["mma"] - l0["mma"], l1["simt"] - l0["simt"]) == (2, 0)
    assert (g1["mma"] - g0["mma"], g1["simt"] - g0["simt"]) == (1, 0)


ROUTE_CASES = [  # (dtype, H, the LSTM's route, the GRU's route)
    (torch.float32, 128, "simt", "simt"), (torch.bfloat16, 144, "wide", "wide"),
    (torch.bfloat16, 40, "simt", "simt"), (torch.bfloat16, 128, "mma", "mma"),
    (torch.bfloat16, 48, "mma", "mma"), (torch.float32, 264, "wide_f32", "simt"),
    (torch.float32, 336, "wide_f32", "wide_f32"),
]


def _route_counts(before, after, route):
    """(launches on ``route``, launches on every other route) between two
    ``.routes`` snapshots."""
    moved = {r: after[r] - before[r] for r in after}
    return moved[route], sum(moved.values()) - moved[route]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,route,gru_route", ROUTE_CASES)
def test_forward_route_is_chosen_from_dtype_and_width(cuda_device, dtype, H, route, gru_route):
    """Widths outside the tensor-core route launch the CUDA-core kernels,
    bf16 past 128 the tensor-core cluster kernels, f32 at the one-block
    widths the f32 narrow kernels and past them up to 512 the f32 cluster
    kernels; each call counts on its route alone, and agrees with its twin."""
    T, B = 24, 5
    if dtype == torch.bfloat16:  # a bf16 call sent to a cluster takes the tensor cores
        route, gru_route = (("wide_mma" if r == "wide" else r) for r in (route, gru_route))
    else:  # f32 at the one-block kernels' widths takes the narrow kernels
        route, gru_route = (("narrow_f32" if r == "simt" else r) for r in (route, gru_route))
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    lstm_args = _gates(T, B, H, dtype, cuda_device, seed=H)
    gru_args = _gru_gates(T, B, H, dtype, cuda_device, seed=H)
    l0, g0 = _routes()
    with torch.no_grad():
        _close(bilstm_fwd(*lstm_args, with_cells=True),
               bilstm_fwd_reference(*lstm_args, with_cells=True), atol)
        _close(bigru_fwd(*gru_args), bigru_fwd_reference(*gru_args), atol)
    torch.cuda.synchronize()
    l1, g1 = _routes()
    assert _route_counts(l0, l1, route) == (1, 0)
    assert _route_counts(g0, g1, gru_route) == (1, 0)


@pytest.mark.cuda
def test_tensor_core_entries_refuse_other_widths_and_take_unaligned_gates(cuda_device):
    from percivaltts_tpu_torch import _build

    lib = _build.library()
    z = torch.zeros(64, dtype=torch.bfloat16, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    for H in (40, 144, 0):
        p = [z.data_ptr()] * 8
        assert lib.percival_bilstm_fwd_mma(*p[:6], None, None, 1, 1, H, stream) != 0
        assert lib.percival_bigru_fwd_mma(*p, 1, 1, H, stream) != 0
    # a contiguous view 2 bytes past a 16-byte boundary: copied, then launched
    T, B, H = 9, 3, 64
    args = _gates(T, B, H, torch.bfloat16, cuda_device, seed=5)
    flat = torch.empty(T * B * 4 * H + 1, dtype=torch.bfloat16, device=cuda_device)
    odd = flat[1:].view(T, B, 4 * H)
    odd.copy_(args[0])
    assert odd.data_ptr() % 16 == 2
    with torch.no_grad():
        _close(bilstm_fwd(odd, *args[1:]), bilstm_fwd_reference(*args), 2e-2)


# --- the two BPTT routes ------------------------------------------------------

# the training shape, edge shapes (T=1, B not a multiple of 8), the narrow
# widths, and the fakes pass's row count
BWD_MMA_SHAPES = [(512, 32, 128), (517, 3, 128), (1, 5, 128), (40, 11, 16), (33, 9, 64),
                  (24, 13, 48), (40, 160, 128)]


def _bwd_routes():
    return dict(bilstm_bwd.routes), dict(bigru_bwd.routes)


def _close_rel(got, want, rtol):
    """|kernel − twin| within ``rtol`` of the twin's largest |value|."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= rtol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", BWD_MMA_SHAPES)
def test_tensor_core_bptt_matches_twins(cuda_device, T, B, H):
    """bf16, H a multiple of 16 up to 128: both BPTTs launch the tensor-core
    kernels and agree with the twins within 2e-2 of max|twin|."""
    bf16 = torch.bfloat16
    lstm_args = _bwd_args(T, B, H, bf16, cuda_device, seed=T + B)
    gru_args = _gru_bwd_args(T, B, H, bf16, cuda_device, seed=T + B)
    l0, g0 = _bwd_routes()
    with torch.no_grad():
        _close_rel(bilstm_bwd(*lstm_args), bilstm_bwd_reference(*lstm_args), 2e-2)
        got, want = bigru_bwd(*gru_args), bigru_bwd_reference(*gru_args)
        _close_rel(got[:2], want[:2], 2e-2)
        _close_rel(got[2:], want[2:], 2e-2)
    torch.cuda.synchronize()
    l1, g1 = _bwd_routes()
    assert (l1["mma"] - l0["mma"], l1["simt"] - l0["simt"]) == (1, 0)
    assert (g1["mma"] - g0["mma"], g1["simt"] - g0["simt"]) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,route,gru_route", ROUTE_CASES)
def test_bptt_route_is_chosen_from_dtype_and_width(cuda_device, dtype, H, route, gru_route):
    """f32 and widths outside the tensor-core route launch the CUDA-core
    BPTT kernels (the LSTM's f32 cluster kernel past H = 256), bf16 past 128
    the tensor-core cluster kernels; each call counts on its route alone and
    agrees with its twin. The CUDA-core GRU BPTT runs H that is not a
    multiple of 32 zero-padded to one."""
    T, B = 24, 5
    lstm_args = _bwd_args(T, B, H, dtype, cuda_device, seed=H)
    gru_args = _gru_bwd_args(T, B, H, dtype, cuda_device, seed=H)
    # a call sent to a cluster takes the tensor cores in bf16; in f32 at
    # these 5 rows the f32 cluster BPTT, whose launcher takes its few-row
    # kernels there (csrc/wide_f32_few.cuh), as the forward takes "wide_f32"
    cluster = "wide_mma" if dtype == torch.bfloat16 else "wide_f32"
    # in f32 the one-block widths take the f32 narrow cluster BPTT
    narrow = "narrow_f32" if dtype == torch.float32 else "simt"
    route, gru_route = ((cluster if r in ("wide", "wide_f32") else narrow if r == "simt" else r)
                        for r in (route, gru_route))
    l0, g0 = _bwd_routes()
    with torch.no_grad():
        got, want = bilstm_bwd(*lstm_args), bilstm_bwd_reference(*lstm_args)
        if dtype == torch.float32:
            _close(got, want, 1e-4)
        else:
            _close_rel(got, want, 2e-2)
        got, want = bigru_bwd(*gru_args), bigru_bwd_reference(*gru_args)
        for sl in (slice(0, 2), slice(2, 4)):
            if dtype == torch.float32:
                _close(got[sl], want[sl], 1e-4)
            else:
                _close_rel(got[sl], want[sl], 2e-2)
    torch.cuda.synchronize()
    l1, g1 = _bwd_routes()
    assert _route_counts(l0, l1, route) == (1, 0)
    assert _route_counts(g0, g1, gru_route) == (1, 0)


@pytest.mark.cuda
def test_tensor_core_bptt_refuses_other_widths_and_takes_unaligned_views(cuda_device):
    from percivaltts_tpu_torch import _build

    lib = _build.library()
    z = torch.zeros(64, dtype=torch.bfloat16, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    for H in (40, 144, 0):
        p = [z.data_ptr()] * 16
        assert lib.percival_bilstm_bwd_mma(*p, 1, 1, H, stream) != 0
        assert lib.percival_bigru_bwd_mma(*p, 1, 1, H, stream) != 0

    def unaligned(t):  # a contiguous view 2 bytes past a 16-byte boundary
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 2
        return view

    T, B, H = 9, 3, 64
    lstm_args = _bwd_args(T, B, H, torch.bfloat16, cuda_device, seed=5)
    gru_args = _gru_bwd_args(T, B, H, torch.bfloat16, cuda_device, seed=5)
    l0, g0 = _bwd_routes()
    with torch.no_grad():
        odd = [unaligned(lstm_args[0])] + lstm_args[1:-1] + [unaligned(lstm_args[-1])]
        _close_rel(bilstm_bwd(*odd), bilstm_bwd_reference(*lstm_args), 2e-2)
        odd = [unaligned(gru_args[0])] + gru_args[1:-1] + [unaligned(gru_args[-1])]
        got, want = bigru_bwd(*odd), bigru_bwd_reference(*gru_args)
        _close_rel(got[:2], want[:2], 2e-2)
        _close_rel(got[2:], want[2:], 2e-2)
    torch.cuda.synchronize()
    l1, g1 = _bwd_routes()
    assert (l1["mma"] - l0["mma"], g1["mma"] - g0["mma"]) == (1, 1)


# --- the cluster kernels (the "wide" route) -----------------------------------

# widths one block cannot hold (LSTM H = 264, 512, 608; GRU H = 336 — the
# 321…341 its one-block BPTT refused —, 352, 512, 640), the serving and
# training row counts, T = 1, B not a multiple of a tile, and H = 1 and 100
# launched through fwd_launch / bwd_launch (the route takes them in no call)
WIDE_SHAPES = [(33, 9, 264), (64, 1, 608), (40, 32, 512), (1, 1, 512), (24, 5, 512)]
GRU_WIDE_SHAPES = [(33, 9, 336), (64, 1, 640), (40, 32, 512), (1, 1, 512), (24, 5, 352)]
WIDE_CASES = [("lstm", *s) for s in WIDE_SHAPES] + [("gru", *s) for s in GRU_WIDE_SHAPES]


def _wide_route(dtype, H, cell):
    """The route of a forward sent to the cluster kernels at the widths of
    ``WIDE_CASES``: bf16 on the tensor cores, f32 up to H = 512 on its own
    cluster kernels (``"wide_f32"``), past it on ``"wide"``."""
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    if dtype == torch.bfloat16:
        return "wide_mma"
    route = fwd_route(dtype, H, cell)
    assert route == ("wide_f32" if H <= 512 else "wide")
    return route


def _wide_bwd_route(dtype, H, cell):
    """The route of a BPTT of ``B`` rows sent to the cluster kernels: the
    forward's, so in f32 up to H = 512 the f32 cluster BPTT (``"wide_f32"``,
    its few-row kernels at B <= 8), past it ``"wide"`` (``bwd_route``)."""
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    route = bwd_route(dtype, H, cell)
    assert route in ("wide_mma" if dtype == torch.bfloat16 else "wide_f32", "wide")
    return route


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell,T,B,H", WIDE_CASES)
def test_wide_kernels_match_twins(cuda_device, dtype, cell, T, B, H):
    """Forward (the LSTM's with and without cells) and BPTT on the cluster
    kernels agree with the twins, each counted once on its route (bf16 on
    the tensor-core cluster kernels, f32 up to H = 512 on its own); in f32
    the CUDA-core cluster forward, launched directly, agrees too."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda

    atol = 1e-4 if dtype == torch.float32 else 2e-2
    if cell == "gru":
        f_args = _gru_gates(T, B, H, dtype, cuda_device, seed=T + B)
        b_args = _gru_bwd_args(T, B, H, dtype, cuda_device, seed=T + B)
        f0, b0 = dict(bigru_fwd.routes), dict(bigru_bwd.routes)
        with torch.no_grad():
            _close(bigru_fwd(*f_args), bigru_fwd_reference(*f_args), atol)
            if dtype == torch.float32:
                _close(gru_cuda.fwd_launch("wide", *f_args), bigru_fwd_reference(*f_args), atol)
            got, want = bigru_bwd(*b_args), bigru_bwd_reference(*b_args)
            if dtype == torch.float32:
                _close(got, want, 1e-4)
            else:  # dgx and dnr each within 2e-2 of its own largest |value|
                _close_rel(got[:2], want[:2], 2e-2)
                _close_rel(got[2:], want[2:], 2e-2)
        torch.cuda.synchronize()
        assert _route_counts(f0, bigru_fwd.routes, _wide_route(dtype, H, cell)) == (1, 0)
        assert _route_counts(b0, bigru_bwd.routes, _wide_bwd_route(dtype, H, cell)) == (1, 0)
        return
    f_args = _gates(T, B, H, dtype, cuda_device, seed=T + B)
    b_args = _bwd_args(T, B, H, dtype, cuda_device, seed=T + B)
    f0, b0 = dict(bilstm_fwd.routes), dict(bilstm_bwd.routes)
    with torch.no_grad():
        want = bilstm_fwd_reference(*f_args, with_cells=True)
        _close(bilstm_fwd(*f_args, with_cells=True), want, atol)
        _close(bilstm_fwd(*f_args), want[:2], atol)
        if dtype == torch.float32:
            _close(lstm_cuda.fwd_launch("wide", *f_args, with_cells=True), want, atol)
        got, want = bilstm_bwd(*b_args), bilstm_bwd_reference(*b_args)
        if dtype == torch.float32:
            _close(got, want, 1e-4)
        else:
            _close_rel(got, want, 2e-2)
    torch.cuda.synchronize()
    assert _route_counts(f0, bilstm_fwd.routes, _wide_route(dtype, H, cell)) == (2, 0)
    assert _route_counts(b0, bilstm_bwd.routes, _wide_bwd_route(dtype, H, cell)) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 100])
def test_wide_kernels_take_narrow_widths(cuda_device, H):
    """The cluster kernels run any H >= 1 when launched directly."""
    from percivaltts_tpu_torch.ops import gru_cuda
    from percivaltts_tpu_torch.ops.lstm_cuda import bwd_launch, fwd_launch

    f_args = _gates(24, 5, H, torch.float32, cuda_device, seed=H)
    b_args = _bwd_args(24, 5, H, torch.float32, cuda_device, seed=H)
    with torch.no_grad():
        _close(fwd_launch("wide", *f_args, with_cells=True),
               bilstm_fwd_reference(*f_args, with_cells=True), 1e-4)
        _close(bwd_launch("wide", *b_args), bilstm_bwd_reference(*b_args), 1e-4)
    f_args = _gru_gates(24, 5, H, torch.float32, cuda_device, seed=H)
    b_args = _gru_bwd_args(24, 5, H, torch.float32, cuda_device, seed=H)
    with torch.no_grad():
        _close(gru_cuda.fwd_launch("wide", *f_args), bigru_fwd_reference(*f_args), 1e-4)
        _close(gru_cuda.bwd_launch("wide", *b_args), bigru_bwd_reference(*b_args), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_autograd_pair_matches_twins(cuda_device, dtype, cell):
    gru = cell == "gru"
    base = (_gru_gates if gru else _gates)(48, 6, 512, dtype, cuda_device, seed=13)
    dy = np.random.default_rng(14).normal(size=(48, 6, 512)).astype(np.float32)
    dy = torch.from_numpy(dy).to(device=cuda_device, dtype=dtype)
    fwd, bwd = (bigru_fwd, bigru_bwd) if gru else (bilstm_fwd, bilstm_bwd)
    cores = (bigru_core, bigru_core_reference) if gru else (bilstm_core, bilstm_core_reference)
    grads = []
    f0, b0 = dict(fwd.routes), dict(bwd.routes)
    for core in cores:
        leaves = [t.clone().requires_grad_(True) for t in base]
        torch.autograd.backward(core(*leaves), (dy, dy))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert _route_counts(f0, fwd.routes, _wide_route(dtype, 512, cell)) == (1, 0)
    assert _route_counts(b0, bwd.routes, _wide_bwd_route(dtype, 512, cell)) == (1, 0)
    for g, w in zip(*grads):
        scale = w.float().abs().max().item()
        tol = 2e-2 * scale if dtype == torch.bfloat16 else 1e-4 * max(1.0, scale)
        assert g.dtype == dtype and (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (1, 264, 512, 608, 4096)]
                         + [("gru", H) for H in (1, 336, 352, 512, 640, 1024, 4096)])
def test_wide_launch_plan_matches_the_layout(cuda_device, cell, H):
    """The launchers split H as ``ops/wide_layout.py::plan`` does, give each
    thread at most one gate pair, and fit the card's clusters."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_layout

    lib = _build.library()
    gates = 3 if cell == "gru" else 4
    p = wide_layout.plan(H, gates)
    name = "bigru" if cell == "gru" else "bilstm"
    fns = [getattr(lib, f"percival_{name}_{kind}_wide_plan") for kind in ("fwd", "bwd")]
    for fn in fns:
        for dtype in (0, 1):
            out = (ctypes.c_int * 9)()
            assert fn(32, H, p.Hb, p.U, dtype, out) == 0
            U, Hb, NC, KS, NT, R, _, clusters, smem = out
            assert (U, Hb, NC, KS, NT) == tuple(p)
            assert R * Hb <= NT and clusters >= 1 and smem > 0
    out = (ctypes.c_int * 9)()
    granule = wide_layout.GRANULE[gates]
    assert fns[0](32, H, p.Hb + granule, p.U, 0, out) != 0 or H < granule


# --- the f32 cluster BPTTs (the "wide_f32" route) -----------------------------

# chip_smoke.py's f32 shapes: the training step's rows, the Pallas-parity
# widths 264 / 336 (zero-padded to 288 / 352, a short last block), T = 1,
# and the fakes pass at B = 160; the widest the route takes, 512, and 320
WIDE_F32_CASES = ([("lstm", *s) for s in [(512, 32, 512), (33, 9, 264), (1, 3, 512), (40, 7, 320)]]
                  + [("gru", *s) for s in [(512, 32, 512), (33, 9, 336), (1, 3, 512), (40, 7, 352)]]
                  + [("lstm", 512, 160, 512), ("gru", 512, 160, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", WIDE_F32_CASES)
def test_wide_f32_bptt_matches_twins(cuda_device, cell, T, B, H):
    """The f32 cluster BPTTs against the twins (1e-4), launched directly and
    through the entry, which counts them once on their route
    (``"wide_f32"``); the earlier CUDA-core cluster BPTT on the same inputs
    agrees too."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.float32, cuda_device, seed=T + B)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    wrapper = bigru_bwd if gru else bilstm_bwd
    route = bwd_route(torch.float32, H, cell)
    assert route == "wide_f32"
    with torch.no_grad():
        _close(m.bwd_launch("wide_f32", *args), want, 1e-4)
        _close(m.bwd_launch("wide", *args), want, 1e-4)
        b0 = dict(wrapper.routes)
        got = wrapper(*args)
        torch.cuda.synchronize()
    assert _route_counts(b0, wrapper.routes, route) == (1, 0)
    _close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (160, 288, 320, 512)]
                         + [("gru", H) for H in (160, 352, 384, 512)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_f32_plan_matches_the_layout(cuda_device, cell, H, B):
    """The launchers split H as ``ops/wide_layout.py::plan`` does and choose
    the kernel, rows and resident chunks ``ops/wide_f32_layout.py::bwd_plan``
    replays at the card's clusters by R (each R's plan forced: the few-row
    kernels at B <= 8 where one fits, else the chunked ones' ``rows``); at
    H = 512, B <= 32 in one wave and B = 160 in two; H not a multiple of 32
    is refused."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf
    from percivaltts_tpu_torch.ops import wide_layout

    gates = 3 if cell == "gru" else 4
    p = wide_layout.plan(H, gates)
    out = _wide_f32_plan(cell, B, H, 0)
    assert out[:3] == (p.U, p.Hb, p.NC) and out.clusters >= 1
    clusters = {R: _wide_f32_plan(cell, 1, H, R).clusters for R in wf.FEW_ROWS + (8, 16, 24)
                if (wf.few_fits(H, gates, R) if R <= 4 else wf.resident(H, gates, R) >= 0)}
    assert tuple(out)[3:6] + tuple(out)[7:] == tuple(wf.bwd_plan(B, H, gates, clusters))
    assert (out.R <= 4) == (B <= wf.FEW_MAX_B and any(wf.few_fits(H, gates, R)
                                                       for R in wf.FEW_ROWS))
    if H == 512:
        assert out.waves == (1 if B <= 32 else 2)
    fn = getattr(_build.library(), f"percival_{'bigru' if gates == 3 else 'bilstm'}_bwd_wide_f32_plan")
    assert fn(B, H + 8, p.Hb, p.U, 0, (ctypes.c_int * 9)()) != 0


def _wide_f32_plan(cell, B, H, rows):
    """The f32 BPTT's launch plan from its library (``rows``: R forced)."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf
    from percivaltts_tpu_torch.ops import wide_layout

    gates = 3 if cell == "gru" else 4
    p = wide_layout.plan(H, gates)
    fn = getattr(_build.library(), f"percival_{'bigru' if gates == 3 else 'bilstm'}_bwd_wide_f32_plan")
    out = (ctypes.c_int * 9)()
    assert fn(B, H, p.Hb, p.U, rows, out) == 0
    return wf.BwdPlan(*out)


# the rows the f32 BPTT kept on the CUDA-core cluster kernel ("wide") before
# its few-row plan, and edges of that plan: B = 3, 5, 7, H = 264 (padded to
# 288), 480
WIDE_F32_FEW_CASES = ([("lstm", 40, B, H) for B, H in [(8, 288), (8, 384), (6, 416), (3, 264),
                                                       (7, 416)]]
                      + [("gru", 40, B, H) for B, H in [(8, 384), (6, 512), (5, 480), (1, 352)]])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", WIDE_F32_FEW_CASES)
def test_wide_f32_few_rows_match_twins(cuda_device, cell, T, B, H):
    """At few rows the entry's f32 BPTT (route ``"wide_f32"``) launches the
    few-row kernels, counted once on the route and once on
    ``.wide_f32_plans["few"]``, within 1e-4·max(1, max|twin|) of the twins,
    as the ``"wide"`` kernel they replaced there on the same inputs."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.float32, cuda_device, seed=B + H)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    tol = 1e-4 * max(1.0, max(w.abs().max().item() for w in want))
    wrapper = bigru_bwd if gru else bilstm_bwd
    assert bwd_route(torch.float32, H, cell) == "wide_f32"
    with torch.no_grad():
        b0, p0 = dict(wrapper.routes), dict(wrapper.wide_f32_plans)
        got = wrapper(*args)
        torch.cuda.synchronize()
        _close(got, want, tol)
        _close(m.bwd_launch("wide", *args), want, tol)
    assert _route_counts(b0, wrapper.routes, "wide_f32") == (1, 0)
    assert _route_counts(p0, wrapper.wide_f32_plans, "few") == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,B,H,R", [("lstm", 8, 384, 1), ("lstm", 8, 384, 2),
                                        ("lstm", 3, 288, 4), ("lstm", 5, 416, 1),
                                        ("gru", 8, 512, 1), ("gru", 7, 512, 2),
                                        ("gru", 2, 384, 4), ("lstm", 160, 384, 4)])
def test_wide_f32_few_rows_forced(cuda_device, cell, B, H, R):
    """``bwd_launch("wide_f32", …, rows=R)`` runs the few-row kernels at R
    rows a cluster at any B (more clusters, or padding rows) and agrees with
    the twins; the plan it takes is R's."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    T = 24
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.float32, cuda_device, seed=B + R)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    with torch.no_grad():
        got = m.bwd_launch("wide_f32", *args, rows=R)
        torch.cuda.synchronize()
    _close(got, want, 1e-4 * max(1.0, max(w.abs().max().item() for w in want)))
    assert lstm_cuda.wide_f32_plan("bigru" if gru else "bilstm", B, H, R).R == R


@pytest.mark.cuda
def test_wide_f32_few_rows_refuse_rows_that_do_not_fit(cuda_device):
    """R = 4 does not fit the LSTM's slice at H = 416, nor any few-row R at
    448; R = 3 is no plan's; each raises before a launch."""
    from percivaltts_tpu_torch.ops import lstm_cuda

    for B, H, R in ((8, 416, 4), (2, 448, 1), (2, 384, 3)):
        with pytest.raises(RuntimeError, match="plan"):
            lstm_cuda.bwd_launch("wide_f32", *_bwd_args(2, B, H, torch.float32, cuda_device,
                                                         seed=1), rows=R)


@pytest.mark.cuda
def test_wide_f32_bptt_refuses_bf16_and_widths_past_its_plan(cuda_device):
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf

    with pytest.raises(TypeError, match="float32"):
        lstm_cuda.bwd_launch("wide_f32", *_bwd_args(2, 1, 512, torch.bfloat16, cuda_device, seed=1))
    with pytest.raises(TypeError, match="float32"):
        gru_cuda.bwd_launch("wide_f32", *_gru_bwd_args(2, 1, 512, torch.bfloat16, cuda_device,
                                                       seed=1))
    for H in (wf.max_h(4) + 1, 128):
        with pytest.raises(ValueError, match=f"H <= {wf.max_h(4)}"):
            lstm_cuda.bwd_launch("wide_f32", *_bwd_args(2, 1, H, torch.float32, cuda_device,
                                                         seed=1))
        with pytest.raises(ValueError, match=f"H <= {wf.max_h(3)}"):
            gru_cuda.bwd_launch("wide_f32", *_gru_bwd_args(2, 1, H, torch.float32, cuda_device,
                                                           seed=1))


# --- the f32 cluster forwards (the "wide_f32" route) --------------------------

# the serving chunk's rows (R = 4) and the fakes pass (R = 8) at the widest
# width, T not a multiple of anything and few rows, T = B = 1, and the
# Pallas-parity widths 264 / 336 (zero-padded to 288 / 352, a short last
# block) at 9 rows (R = 4) and 24 (R = 8)
WIDE_F32_FWD_CASES = [(cell, *s) for cell in ("lstm", "gru") for s in
                      [(512, 8, 512), (512, 160, 512), (517, 3, 512), (1, 1, 512)]]
WIDE_F32_FWD_CASES += [("lstm", 33, 9, 264), ("gru", 33, 9, 336), ("lstm", 40, 24, 264),
                       ("gru", 40, 24, 336)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", WIDE_F32_FWD_CASES)
def test_wide_f32_forward_matches_twins(cuda_device, cell, T, B, H):
    """The f32 cluster forwards against the twins (the LSTM with its cells),
    within 1e-4·max(1, max |v|), launched directly and through the entry,
    which counts them once on their route (``fwd_route``: ``"wide_f32"``);
    the CUDA-core cluster forward they replaced agrees on the same inputs."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_gates if gru else _gates)(T, B, H, torch.float32, cuda_device, seed=T + B)
    cells = {} if gru else {"with_cells": True}
    want = bigru_fwd_reference(*args) if gru else bilstm_fwd_reference(*args, **cells)
    tol = 1e-4 * max(1.0, max(w.abs().max().item() for w in want))
    wrapper = bigru_fwd if gru else bilstm_fwd
    route = fwd_route(torch.float32, H, cell, B)
    assert route == "wide_f32"
    with torch.no_grad():
        _close(m.fwd_launch("wide_f32", *args, **cells), want, tol)
        _close(m.fwd_launch("wide", *args, **cells), want, tol)
        f0 = dict(wrapper.routes)
        got = wrapper(*args, **cells)
        torch.cuda.synchronize()
    assert _route_counts(f0, wrapper.routes, route) == (1, 0)
    _close(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (288, 320, 384, 416, 480, 512)]
                         + [("gru", H) for H in (352, 384, 448, 480, 512)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_f32_forward_plan_matches_the_layout(cuda_device, cell, H, B):
    """The launchers split H as ``ops/wide_layout.py::plan`` does and keep
    the chunks in shared memory and registers that
    ``ops/wide_f32_layout.py::fwd_rows`` replays at the card's clusters; H
    not a multiple of 32 is refused."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf
    from percivaltts_tpu_torch.ops import wide_layout

    gates = 3 if cell == "gru" else 4
    p = wide_layout.plan(H, gates)
    fn = getattr(_build.library(), f"percival_{'bigru' if gates == 3 else 'bilstm'}_fwd_wide_f32_plan")
    out = (ctypes.c_int * 9)()
    assert fn(B, H, p.Hb, p.U, out) == 0
    U, Hb, NC, R, nres, nreg, clusters, waves, smem = out
    assert (U, Hb, NC) == (p.U, p.Hb, p.NC) and clusters >= 1
    assert (R, nres, nreg, waves, smem) == tuple(wf.fwd_rows(B, H, gates, clusters))
    assert fn(B, H + 8, p.Hb, p.U, out) != 0


@pytest.mark.cuda
def test_wide_f32_forward_refuses_bf16_and_widths_past_its_route(cuda_device):
    """bf16, H past 512 and H at the one-block widths raise before any launch."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import wide_f32_layout as wf

    with pytest.raises(TypeError, match="float32"):
        lstm_cuda.fwd_launch("wide_f32", *_gates(2, 1, 512, torch.bfloat16, cuda_device, seed=1))
    with pytest.raises(TypeError, match="float32"):
        gru_cuda.fwd_launch("wide_f32", *_gru_gates(2, 1, 512, torch.bfloat16, cuda_device, seed=1))
    for H in (wf.max_h(4) + 1, 128):
        with pytest.raises(ValueError, match=f"H <= {wf.max_h(4)}"):
            lstm_cuda.fwd_launch("wide_f32", *_gates(2, 1, H, torch.float32, cuda_device, seed=1))
        with pytest.raises(ValueError, match=f"H <= {wf.max_h(3)}"):
            gru_cuda.fwd_launch("wide_f32", *_gru_gates(2, 1, H, torch.float32, cuda_device,
                                                        seed=1))


# --- the f32 narrow cluster BPTTs (the "narrow_f32" route) ---------------------

# chip_smoke.py's f32 shapes at the one-block widths: the training step's and
# the serving chunk's rows, the narrow width, T = 1, the route's widest H,
# a width not a multiple of 8 (zero-padded to 104) and the fakes pass
NARROW_F32_CASES = ([(cell, *s) for cell in ("lstm", "gru") for s in
                     [(512, 32, 128), (512, 8, 128), (33, 9, 64), (1, 3, 128), (24, 5, 100),
                      (64, 160, 128)]]
                    + [("lstm", 40, 7, 256), ("gru", 40, 7, 320)])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", NARROW_F32_CASES)
def test_narrow_f32_bptt_matches_twins(cuda_device, cell, T, B, H):
    """The f32 narrow cluster BPTTs against the twins (1e-4), launched
    directly and through the entry, which counts them once on their route
    (``"narrow_f32"``, or ``"simt"`` where the card measured the one-block
    kernel faster); the one-block BPTT on the same inputs agrees too."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.float32, cuda_device, seed=T + B)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    wrapper = bigru_bwd if gru else bilstm_bwd
    route = bwd_route(torch.float32, H, cell)
    assert route in ("narrow_f32", "simt")
    with torch.no_grad():
        _close(m.bwd_launch("narrow_f32", *args), want, 1e-4)
        _close(m.bwd_launch("simt", *args), want, 1e-4)
        b0 = dict(wrapper.routes)
        got = wrapper(*args)
        torch.cuda.synchronize()
    assert _route_counts(b0, wrapper.routes, route) == (1, 0)
    _close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,blocks", [("lstm", 160, 8), ("gru", 224, 5), ("lstm", 128, 2),
                                           ("gru", 128, 1), ("gru", 320, 8)])
@pytest.mark.parametrize("R", [2, 4, 8, 16])
def test_narrow_f32_splits_and_rows_match_twins(cuda_device, cell, H, blocks, R):
    """Every row tile on splits the launchers' overrides force, among them
    clusters whose last block is short (LSTM H = 160 over 7 blocks of 24
    units, GRU H = 224 over 5 of 48), against the twins (1e-4); a split and
    rows that do not fit a block are refused."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    gru = cell == "gru"
    m, gates = (gru_cuda, 3) if gru else (lstm_cuda, 4)
    if not nf.candidates(H, gates, blocks, R):
        with pytest.raises(RuntimeError, match="plan"):
            lstm_cuda.narrow_f32_plan("bigru" if gru else "bilstm", 7, H, blocks, R)
        return
    args = (_gru_bwd_args if gru else _bwd_args)(20, 7, H, torch.float32, cuda_device, seed=H)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    with torch.no_grad():
        _close(m.bwd_launch("narrow_f32", *args, blocks=blocks, rows=R), want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_narrow_f32_plan_matches_the_layout(cuda_device, cell):
    """The launchers' plans equal ``ops/narrow_f32_layout.py::plan`` replayed
    at the card's clusters of each split (the launchers' plan with that split
    forced) at H = 64, 128 and the route's widest, B = 1, 8, 32, 160; the
    launch refuses a split other than its plan's."""
    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    gates, name = (3, "bigru") if cell == "gru" else (4, "bilstm")
    for H in (64, 128, nf.MAX_H[gates]):
        card = {s.U: lstm_cuda.narrow_f32_plan(name, 1, H, s.U, R).clusters
                for s, R, _ in nf.candidates(H, gates)}
        for B in (1, 8, 32, 160):
            p = lstm_cuda.narrow_f32_plan(name, B, H)
            assert p == nf.plan(B, H, gates, card)
            assert p.smem <= nf.SMEM_OPTIN and p.clusters >= 1
    z = torch.zeros(64, device=cuda_device)
    fn = getattr(_build.library(), f"percival_{name}_bwd_narrow_f32")
    p = lstm_cuda.narrow_f32_plan(name, 8, 128)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(*[z.data_ptr()] * 14, 1, 8, 128, p.Hb + 8, p.U, p.R, stream) != 0


@pytest.mark.cuda
def test_narrow_f32_bptt_refuses_bf16_and_widths_past_its_route(cuda_device):
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    with pytest.raises(TypeError, match="float32"):
        lstm_cuda.bwd_launch("narrow_f32", *_bwd_args(2, 1, 64, torch.bfloat16, cuda_device,
                                                      seed=1))
    with pytest.raises(TypeError, match="float32"):
        gru_cuda.bwd_launch("narrow_f32", *_gru_bwd_args(2, 1, 64, torch.bfloat16, cuda_device,
                                                         seed=1))
    with pytest.raises(ValueError, match=f"H <= {nf.MAX_H[4]}"):
        lstm_cuda.bwd_launch("narrow_f32", *_bwd_args(2, 1, nf.MAX_H[4] + 1, torch.float32,
                                                      cuda_device, seed=1))
    with pytest.raises(ValueError, match=f"H <= {nf.MAX_H[3]}"):
        gru_cuda.bwd_launch("narrow_f32", *_gru_bwd_args(2, 1, nf.MAX_H[3] + 1, torch.float32,
                                                         cuda_device, seed=1))


# --- the f32 narrow forwards (the "narrow_f32" route) --------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", NARROW_F32_CASES)
def test_narrow_f32_forward_matches_twins(cuda_device, cell, T, B, H):
    """The f32 narrow forwards against the twins (1e-4; the LSTM with its
    cells), launched directly and through the entry, which counts them once
    on their route (``fwd_route``: ``"narrow_f32"``); the one-block forward
    on the same inputs agrees too."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_gates if gru else _gates)(T, B, H, torch.float32, cuda_device, seed=T + B)
    cells = {} if gru else {"with_cells": True}
    want = bigru_fwd_reference(*args) if gru else bilstm_fwd_reference(*args, **cells)
    wrapper = bigru_fwd if gru else bilstm_fwd
    route = fwd_route(torch.float32, H, cell)
    assert route == "narrow_f32"
    with torch.no_grad():
        _close(m.fwd_launch("narrow_f32", *args, **cells), want, 1e-4)
        _close(m.fwd_launch("simt", *args, **cells), want, 1e-4)
        f0 = dict(wrapper.routes)
        got = wrapper(*args, **cells)
        torch.cuda.synchronize()
    assert _route_counts(f0, wrapper.routes, route) == (1, 0)
    _close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H,blocks,resident", [
    ("lstm", 160, 8, 0), ("gru", 224, 5, 0), ("lstm", 128, 2, 0), ("gru", 128, 1, 0),
    ("gru", 320, 8, 0), ("lstm", 96, 1, 1), ("gru", 128, 1, 1), ("lstm", 64, 1, 1)])
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_narrow_f32_forward_splits_and_rows_match_twins(cuda_device, cell, H, blocks, resident, R):
    """Every row tile on the plans the launchers' overrides force, W_h in
    shared memory over splits among them clusters whose last block is short
    (LSTM H = 160 over 7 blocks of 24 units, GRU H = 224 over 5 of 48), and
    in registers (R = 1, 2), against the twins (1e-4); a plan that does not
    fit is refused."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    gru = cell == "gru"
    m, gates = (gru_cuda, 3) if gru else (lstm_cuda, 4)
    fits = (R in nf.REG_ROWS and nf.reg_fits(H, gates)) if resident else \
        bool(nf.candidates(H, gates, blocks, R, fwd=True))
    if not fits:
        with pytest.raises(RuntimeError, match="plan"):
            lstm_cuda.narrow_f32_fwd_plan("bigru" if gru else "bilstm", 7, H, blocks, R, resident)
        return
    args = (_gru_gates if gru else _gates)(20, 7, H, torch.float32, cuda_device, seed=H)
    cells = {} if gru else {"with_cells": True}
    want = bigru_fwd_reference(*args) if gru else bilstm_fwd_reference(*args, **cells)
    with torch.no_grad():
        _close(m.fwd_launch("narrow_f32", *args, **cells, blocks=blocks, rows=R,
                            resident=resident), want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_narrow_f32_forward_plan_matches_the_layout(cuda_device, cell):
    """The forward launchers' plans equal ``ops/narrow_f32_layout.py::fwd_plan``
    replayed at the card's clusters of each split and of the kernel that
    holds W_h in registers (the launchers' plan with that forced) at H = 64,
    128 and the route's widest, B = 1, 8, 32, 160; the launch refuses a plan
    other than its own."""
    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    gates, name = (3, "bigru") if cell == "gru" else (4, "bilstm")
    for H in (64, 128, nf.MAX_H[gates]):
        card = {s.U: lstm_cuda.narrow_f32_fwd_plan(name, 1, H, s.U, R, 0).clusters
                for s, R, _ in nf.candidates(H, gates, fwd=True)}
        if nf.reg_fits(H, gates):
            card["resident"] = lstm_cuda.narrow_f32_fwd_plan(name, 1, H, 1, 1, 1).clusters
        for B in (1, 8, 32, 160):
            p = lstm_cuda.narrow_f32_fwd_plan(name, B, H)
            assert p == nf.fwd_plan(B, H, gates, card)
            assert p.smem <= nf.SMEM_OPTIN and p.clusters >= 1
    z = torch.zeros(64, device=cuda_device)
    fn = getattr(_build.library(), f"percival_{name}_fwd_narrow_f32")
    p = lstm_cuda.narrow_f32_fwd_plan(name, 8, 128)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(*[z.data_ptr()] * 8, 1, 8, 128, p.Hb + 8, p.U, p.R, p.resident, stream) != 0
    assert fn(*[z.data_ptr()] * 8, 1, 8, 128, p.Hb, p.U, p.R, 1 - p.resident, stream) != 0


@pytest.mark.cuda
def test_gru_fwd_launch_narrow_f32_returns_the_forward(cuda_device):
    """``gru_cuda.fwd_launch("narrow_f32", …)`` launches the GRU forward and
    returns its ``(y_f, y_b)``, equal to the twin's (1e-4)."""
    from percivaltts_tpu_torch.ops import gru_cuda

    args = _gru_gates(40, 6, 128, torch.float32, cuda_device, seed=3)
    with torch.no_grad():
        got = gru_cuda.fwd_launch("narrow_f32", *args)
        torch.cuda.synchronize()
    assert len(got) == 2 and all(y.shape == (40, 6, 128) for y in got)
    _close(got, bigru_fwd_reference(*args), 1e-4)


@pytest.mark.cuda
def test_narrow_f32_forward_refuses_bf16_and_widths_past_its_route(cuda_device):
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import narrow_f32_layout as nf

    with pytest.raises(TypeError, match="float32"):
        lstm_cuda.fwd_launch("narrow_f32", *_gates(2, 1, 64, torch.bfloat16, cuda_device, seed=1))
    with pytest.raises(TypeError, match="float32"):
        gru_cuda.fwd_launch("narrow_f32", *_gru_gates(2, 1, 64, torch.bfloat16, cuda_device,
                                                      seed=1))
    with pytest.raises(ValueError, match=f"H <= {nf.MAX_H[4]}"):
        lstm_cuda.fwd_launch("narrow_f32", *_gates(2, 1, nf.MAX_H[4] + 1, torch.float32,
                                                   cuda_device, seed=1))
    with pytest.raises(ValueError, match=f"H <= {nf.MAX_H[3]}"):
        gru_cuda.fwd_launch("narrow_f32", *_gru_gates(2, 1, nf.MAX_H[3] + 1, torch.float32,
                                                      cuda_device, seed=1))


# --- the tensor-core cluster BPTTs (the "wide_mma" route) ----------------------

# chip_smoke.py's WIDE_BWD_SHAPES / WIDE_GRU_BWD_SHAPES (the training step's
# rows, the Pallas-parity widths 264 / 336, the widest Pallas widths 608 /
# 640, H = 100 zero-padded to 128) and the fakes pass at B = 160
WIDE_MMA_CASES = ([("lstm", *s) for s in [(512, 32, 512), (33, 9, 264), (40, 1, 608), (24, 5, 100)]]
                  + [("gru", *s) for s in [(512, 32, 512), (33, 9, 336), (40, 1, 640), (24, 5, 100)]]
                  + [("lstm", 512, 160, 512), ("gru", 512, 160, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", WIDE_MMA_CASES)
def test_wide_mma_bptt_matches_twins(cuda_device, cell, T, B, H):
    """The tensor-core cluster BPTTs against the twins in bf16 (2e-2 of the
    largest |dgx| / |dnr|), launched directly; through the entry where the
    route takes H, counted once on it."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.bfloat16, cuda_device, seed=T + B)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    parts = (slice(0, 2), slice(2, 4)) if gru else (slice(0, 2),)
    with torch.no_grad():
        got = m.bwd_launch("wide_mma", *args)
        for sl in parts:
            _close_rel(got[sl], want[sl], 2e-2)
        if bwd_route(torch.bfloat16, H, cell) == "wide_mma":
            wrapper = bigru_bwd if gru else bilstm_bwd
            b0 = dict(wrapper.routes)
            got = wrapper(*args)
            torch.cuda.synchronize()
            assert _route_counts(b0, wrapper.routes, "wide_mma") == (1, 0)
            for sl in parts:
                _close_rel(got[sl], want[sl], 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_mma_autograd_pair_matches_twins(cuda_device, cell):
    """The autograd pair at chip_smoke.py's WIDE_AUTOGRAD_SHAPE (512, 32, 512)
    in bf16: the tensor-core cluster forward and BPTT."""
    gru = cell == "gru"
    T, B, H = 512, 32, 512
    base = (_gru_gates if gru else _gates)(T, B, H, torch.bfloat16, cuda_device, seed=7)
    dy = np.random.default_rng(1).normal(size=(T, B, H)).astype(np.float32)
    dy = torch.from_numpy(dy).to(device=cuda_device, dtype=torch.bfloat16)
    fwd, bwd = (bigru_fwd, bigru_bwd) if gru else (bilstm_fwd, bilstm_bwd)
    cores = (bigru_core, bigru_core_reference) if gru else (bilstm_core, bilstm_core_reference)
    grads = []
    f0, b0 = dict(fwd.routes), dict(bwd.routes)
    for core in cores:
        leaves = [t.clone().requires_grad_(True) for t in base]
        torch.autograd.backward(core(*leaves), (dy, dy))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert _route_counts(f0, fwd.routes, "wide_mma") == (1, 0)
    assert _route_counts(b0, bwd.routes, "wide_mma") == (1, 0)
    for g, w in zip(*grads):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (160, 288, 512, 608)]
                         + [("gru", H) for H in (160, 352, 512, 640, 672)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_mma_plan_matches_the_layout(cuda_device, cell, H, B):
    """The launchers split H as ``ops/wide_mma_layout.py::plan`` does and
    choose the rows ``rows`` replays at the card's clusters; B = 8 and 32
    run in one wave."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gates = 3 if cell == "gru" else 4
    p = wm.plan(H, gates)
    fn = getattr(_build.library(), f"percival_{'bigru' if gates == 3 else 'bilstm'}_bwd_wide_mma_plan")
    out = (ctypes.c_int * 9)()
    assert fn(B, H, p.Hb, p.U, out) == 0
    U, Hb, NC, R, MPW, clusters, waves, dbuf, smem = out
    assert (U, Hb, NC) == tuple(p) and clusters >= 1
    assert (R, MPW, waves, dbuf, smem) == tuple(wm.rows(B, H, gates, clusters))
    if B <= 32 and H == 512:
        assert waves == 1
    assert fn(B, H + 8, p.Hb, p.U, out) != 0  # H not a multiple of 32


# --- the streamed tensor-core cluster BPTTs (the "wide_mma_stream" route) ------

# chip_smoke.py phase 17's STREAM_SHAPES at small T (the route's first widths,
# a padded width, its widest, the models' H = 1024 at the training row count)
STREAM_CASES = ([("lstm", *s) for s in [(33, 9, 640), (40, 1, 1000), (33, 9, 1536), (64, 32, 1024)]]
                + [("gru", *s) for s in [(33, 9, 704), (40, 1, 1000), (33, 9, 1792), (64, 32, 1024)]])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", STREAM_CASES)
def test_wide_mma_stream_bptt_matches_twins(cuda_device, cell, T, B, H):
    """The streamed BPTTs against the twins in bf16 (2e-2 of max(1, the
    largest |dgx| / |dnr|)), through the entry, counted once on the route."""
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    assert bwd_route(torch.bfloat16, H, cell) == "wide_mma_stream"
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.bfloat16, cuda_device, seed=T + B)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    wrapper = bigru_bwd if gru else bilstm_bwd
    b0 = dict(wrapper.routes)
    with torch.no_grad():
        got = wrapper(*args)
    torch.cuda.synchronize()
    assert _route_counts(b0, wrapper.routes, "wide_mma_stream") == (1, 0)
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_mma_stream_autograd_pair_matches_twins(cuda_device, cell):
    """The autograd pair at chip_smoke.py's STREAM_AUTOGRAD_SHAPE width
    (H = 1024, T = 64, B = 32) in bf16: the forward and the BPTT on
    "wide_mma_stream", each counted once."""
    gru = cell == "gru"
    T, B, H = 64, 32, 1024
    base = (_gru_gates if gru else _gates)(T, B, H, torch.bfloat16, cuda_device, seed=7)
    dy = np.random.default_rng(1).normal(size=(T, B, H)).astype(np.float32)
    dy = torch.from_numpy(dy).to(device=cuda_device, dtype=torch.bfloat16)
    fwd, bwd = (bigru_fwd, bigru_bwd) if gru else (bilstm_fwd, bilstm_bwd)
    cores = (bigru_core, bigru_core_reference) if gru else (bilstm_core, bilstm_core_reference)
    grads = []
    f0, b0 = dict(fwd.routes), dict(bwd.routes)
    for core in cores:
        leaves = [t.clone().requires_grad_(True) for t in base]
        torch.autograd.backward(core(*leaves), (dy, dy))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert _route_counts(f0, fwd.routes, "wide_mma_stream") == (1, 0)
    assert _route_counts(b0, bwd.routes, "wide_mma_stream") == (1, 0)
    for g, w in zip(*grads):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (640, 1024, 1536, 1568, 2048, 3840, 4096)]
                         + [("gru", H) for H in (704, 1024, 1792, 1824, 2048, 3840, 4096)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_mma_stream_plan_matches_the_layout(cuda_device, cell, H, B):
    """The launchers split H as ``ops/wide_mma_layout.py::plan`` does and
    choose the plan ``stream_plan`` replays at the card's clusters (the
    layout, rows, chunks resident and streamed, pairs a compute warp, waves,
    slot buffers, shared memory, the deep layout's scratch); a width past
    the BPTT's limit, or not a multiple of 32, has no plan."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gates = 3 if cell == "gru" else 4
    p = wm.plan(H, gates)
    name = "bigru" if gates == 3 else "bilstm"
    fn = getattr(_build.library(), f"percival_{name}_bwd_wide_mma_stream_plan")
    out = (ctypes.c_int * 14)()
    assert fn(B, H, p.Hb, p.U, out) == 0
    got = wm.StreamPlan(*out)
    assert got == wm.stream_plan(B, H, gates, got.clusters) and got.clusters >= 1
    assert (got.chunk == wm.DEEP_CHUNK) == (H > wm.stream_max_h(gates))
    assert fn(B, H + 8, p.Hb, p.U, out) != 0  # H not a multiple of 32
    past = wm.stream_bwd_max_h(gates) + 64
    q = wm.plan(past, gates)
    assert fn(B, past, q.Hb, q.U, out) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_mma_stream_refuses_f32_and_widths_past_its_limit(cuda_device, cell):
    """On CUDA tensors the streamed route launches its kernel or raises:
    f32 ``TypeError``, H past ``stream_bwd_max_h`` (4096) ``ValueError``
    naming it."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gru = cell == "gru"
    m, gates = (gru_cuda, 3) if gru else (lstm_cuda, 4)
    args = (_gru_bwd_args if gru else _bwd_args)(2, 1, 640, torch.float32, cuda_device, seed=1)
    with pytest.raises(TypeError, match="bfloat16"):
        m.bwd_launch("wide_mma_stream", *args)
    past = wm.stream_bwd_max_h(gates) + 32
    args = (_gru_bwd_args if gru else _bwd_args)(2, 1, past, torch.bfloat16, cuda_device, seed=1)
    with pytest.raises(ValueError, match=f"H <= {wm.stream_bwd_max_h(gates)}"):
        m.bwd_launch("wide_mma_stream", *args)


# chip_smoke.py phase 18's DEEP_SHAPES at small T: the BPTTs' deep layout (its
# first widths, a padded width, its widest, the models' H = 2048 at the
# training row count; 4096 on the LSTM's 4-pair and the GRU's 2-pair kernel)
DEEP_CASES = ([("lstm", *s) for s in [(33, 9, 1568), (40, 1, 2000), (17, 3, 3840), (64, 32, 2048),
                                      (17, 3, 4096)]]
              + [("gru", *s) for s in [(33, 9, 1824), (40, 1, 2000), (17, 3, 3840), (64, 32, 2048),
                                      (17, 3, 4096)]])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", DEEP_CASES)
def test_wide_mma_stream_deep_bptt_matches_twins(cuda_device, cell, T, B, H):
    """The streamed BPTTs past the 64-k layout's widths against the twins in
    bf16 (2e-2 of max(1, the largest |dgx| / |dnr|)), through the entry,
    counted once on the route and once on the deep layout."""
    from percivaltts_tpu_torch.ops.mma_layout import bwd_route

    gru = cell == "gru"
    assert bwd_route(torch.bfloat16, H, cell, B) == "wide_mma_stream"
    args = (_gru_bwd_args if gru else _bwd_args)(T, B, H, torch.bfloat16, cuda_device, seed=T + B)
    want = (bigru_bwd_reference if gru else bilstm_bwd_reference)(*args)
    wrapper = bigru_bwd if gru else bilstm_bwd
    b0, d0 = dict(wrapper.routes), wrapper.stream_layouts["deep"]
    with torch.no_grad():
        got = wrapper(*args)
    torch.cuda.synchronize()
    assert _route_counts(b0, wrapper.routes, "wide_mma_stream") == (1, 0)
    assert wrapper.stream_layouts["deep"] == d0 + 1
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_mma_stream_deep_autograd_pair_matches_twins(cuda_device, cell):
    """The autograd pair at phase 18's width (H = 2048, T = 64, B = 32) in
    bf16: the forward on "wide", the BPTT on the streamed kernels' deep
    layout, each counted once."""
    gru = cell == "gru"
    T, B, H = 64, 32, 2048
    base = (_gru_gates if gru else _gates)(T, B, H, torch.bfloat16, cuda_device, seed=7)
    dy = np.random.default_rng(1).normal(size=(T, B, H)).astype(np.float32)
    dy = torch.from_numpy(dy).to(device=cuda_device, dtype=torch.bfloat16)
    fwd, bwd = (bigru_fwd, bigru_bwd) if gru else (bilstm_fwd, bilstm_bwd)
    cores = (bigru_core, bigru_core_reference) if gru else (bilstm_core, bilstm_core_reference)
    grads = []
    f0, b0, d0 = dict(fwd.routes), dict(bwd.routes), bwd.stream_layouts["deep"]
    for core in cores:
        leaves = [t.clone().requires_grad_(True) for t in base]
        torch.autograd.backward(core(*leaves), (dy, dy))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert _route_counts(f0, fwd.routes, "wide") == (1, 0)
    assert _route_counts(b0, bwd.routes, "wide_mma_stream") == (1, 0)
    assert bwd.stream_layouts["deep"] == d0 + 1
    for g, w in zip(*grads):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


# --- the streamed tensor-core cluster forwards (the "wide_mma_stream" route) ----


STREAM_FWD_CASES = ([(*c, True) for c in STREAM_CASES + [("lstm", 20, 160, 1024),
                                                         ("gru", 20, 160, 1024)]]
                    + [(*c, False) for c in STREAM_CASES if c[0] == "lstm"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H,cells", STREAM_FWD_CASES)
def test_wide_mma_stream_forward_matches_twins(cuda_device, cell, T, B, H, cells):
    """The streamed forwards against the twins in bf16 (2e-2 of max(1, the
    largest |y| / |c|)), through the entry (the LSTM with and without its
    cells), counted once on the route."""
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    gru = cell == "gru"
    assert fwd_route(torch.bfloat16, H, cell, B) == "wide_mma_stream"
    args = (_gru_gates if gru else _gates)(T, B, H, torch.bfloat16, cuda_device, seed=T + B)
    kw = {} if gru else {"with_cells": cells}
    want = (bigru_fwd_reference if gru else bilstm_fwd_reference)(*args, **kw)
    wrapper = bigru_fwd if gru else bilstm_fwd
    f0 = dict(wrapper.routes)
    with torch.no_grad():
        got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert _route_counts(f0, wrapper.routes, "wide_mma_stream") == (1, 0)
    assert len(got) == len(want)
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (640, 1024, 1536)]
                         + [("gru", H) for H in (704, 1024, 1792)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_mma_stream_forward_plan_matches_the_layout(cuda_device, cell, H, B):
    """The forward launchers split H as ``ops/wide_mma_layout.py::plan`` does
    and choose the plan ``stream_fwd_plan`` replays at the card's clusters
    (rows, pairs a compute warp, chunks resident and streamed, waves, h
    buffers, shared memory), also at a forced R; a width not a multiple of
    32, or past the plan's own reach (the LSTM past H = 1920, where a block
    would hold more than 15 unit groups; the GRU past 2560, where the ring
    and an 8-row h tile leave its shared memory; the route's narrower limit
    is the launchers', held by the refusals below), or a negative R, has no
    plan."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gates = 3 if cell == "gru" else 4
    p = wm.plan(H, gates)
    name = "bigru" if gates == 3 else "bilstm"
    fn = getattr(_build.library(), f"percival_{name}_fwd_wide_mma_stream_plan")
    out = (ctypes.c_int * 11)()
    assert fn(B, H, p.Hb, p.U, 0, out) == 0
    got = wm.StreamFwdPlan(*out)
    assert got == wm.stream_fwd_plan(B, H, gates, got.clusters) and got.clusters >= 1
    assert fn(B, H, p.Hb, p.U, 16, out) == 0
    assert wm.StreamFwdPlan(*out) == wm.stream_fwd_plan(B, H, gates, got.clusters, rows=16)
    assert fn(B, H + 8, p.Hb, p.U, 0, out) != 0  # H not a multiple of 32
    assert fn(B, H, p.Hb, p.U, -8, out) != 0  # a negative R
    past = {4: 1920, 3: 2560}[gates] + 64
    q = wm.plan(past, gates)
    assert fn(B, past, q.Hb, q.U, 0, out) != 0
    with pytest.raises(ValueError, match="no rows a cluster fit"):
        wm.stream_fwd_plan(B, past, gates, got.clusters)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_mma_stream_forward_refuses_f32_and_widths_past_its_limit(cuda_device, cell):
    """On CUDA tensors the streamed forward launches its kernel or raises:
    f32 ``TypeError``, H past ``stream_max_h`` ``ValueError`` naming it."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gru = cell == "gru"
    m, gates = (gru_cuda, 3) if gru else (lstm_cuda, 4)
    args = (_gru_gates if gru else _gates)(2, 1, 640, torch.float32, cuda_device, seed=1)
    with pytest.raises(TypeError, match="bfloat16"):
        m.fwd_launch("wide_mma_stream", *args)
    past = wm.stream_max_h(gates) + 32
    args = (_gru_gates if gru else _gates)(2, 1, past, torch.bfloat16, cuda_device, seed=1)
    with pytest.raises(ValueError, match=f"H <= {wm.stream_max_h(gates)}"):
        m.fwd_launch("wide_mma_stream", *args)


@pytest.mark.cuda
def test_wide_mma_bptt_refuses_f32_and_widths_past_shared_memory(cuda_device):
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    # the forwards likewise
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.fwd_launch("wide_mma", *_gates(2, 1, 256, torch.float32, cuda_device, seed=1))
    with pytest.raises(TypeError, match="bfloat16"):
        gru_cuda.fwd_launch("wide_mma", *_gru_gates(2, 1, 256, torch.float32, cuda_device, seed=1))
    with pytest.raises(ValueError, match=f"H <= {wm.max_h(4)}"):
        lstm_cuda.fwd_launch("wide_mma", *_gates(2, 1, wm.max_h(4) + 1, torch.bfloat16,
                                                 cuda_device, seed=1))
    with pytest.raises(ValueError, match=f"H <= {wm.max_h(3)}"):
        gru_cuda.fwd_launch("wide_mma", *_gru_gates(2, 1, wm.max_h(3) + 1, torch.bfloat16,
                                                    cuda_device, seed=1))

    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.bwd_launch("wide_mma", *_bwd_args(2, 1, 256, torch.float32, cuda_device, seed=1))
    with pytest.raises(TypeError, match="bfloat16"):
        gru_cuda.bwd_launch("wide_mma", *_gru_bwd_args(2, 1, 256, torch.float32, cuda_device,
                                                      seed=1))
    H = wm.max_h(4) + 1
    with pytest.raises(ValueError, match=f"H <= {wm.max_h(4)}"):
        lstm_cuda.bwd_launch("wide_mma", *_bwd_args(2, 1, H, torch.bfloat16, cuda_device, seed=1))
    H = wm.max_h(3) + 1
    with pytest.raises(ValueError, match=f"H <= {wm.max_h(3)}"):
        gru_cuda.bwd_launch("wide_mma", *_gru_bwd_args(2, 1, H, torch.bfloat16, cuda_device,
                                                      seed=1))


# --- the tensor-core cluster forwards (the "wide_mma" route) -------------------

# chip_smoke.py's WIDE_FWD_SHAPES / WIDE_GRU_FWD_SHAPES (the serving chunk,
# edges, the fakes pass at B = 160, the short last blocks at 264 / 336 / 352 /
# 608 / 640) and H = 100 zero-padded to 128
WIDE_MMA_FWD_CASES = (
    [("lstm", *s) for s in [(512, 8, 512), (517, 3, 512), (1, 1, 512), (512, 160, 512),
                            (33, 9, 264), (64, 1, 608), (24, 5, 100)]]
    + [("gru", *s) for s in [(512, 8, 512), (517, 3, 512), (1, 1, 512), (512, 160, 512),
                             (33, 9, 336), (33, 9, 352), (64, 1, 640), (24, 5, 100)]])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,T,B,H", WIDE_MMA_FWD_CASES)
def test_wide_mma_forward_matches_twins(cuda_device, cell, T, B, H):
    """The tensor-core cluster forwards against the twins in bf16 (2e-2; the
    LSTM with and without cells), launched directly; through the entry where
    the route takes H, counted once on it; the CUDA-core cluster forward
    launched on the same inputs agrees too."""
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
    from percivaltts_tpu_torch.ops.mma_layout import fwd_route

    gru = cell == "gru"
    m = gru_cuda if gru else lstm_cuda
    args = (_gru_gates if gru else _gates)(T, B, H, torch.bfloat16, cuda_device, seed=T + B)
    kw = {} if gru else {"with_cells": True}
    with torch.no_grad():
        want = (bigru_fwd_reference(*args) if gru
                else bilstm_fwd_reference(*args, with_cells=True))
        _close(m.fwd_launch("wide_mma", *args, **kw), want, 2e-2)
        _close(m.fwd_launch("wide", *args, **kw), want, 2e-2)
        if not gru:
            _close(m.fwd_launch("wide_mma", *args), want[:2], 2e-2)
        if fwd_route(torch.bfloat16, H, cell) == "wide_mma":
            wrapper = bigru_fwd if gru else bilstm_fwd
            f0 = dict(wrapper.routes)
            got = wrapper(*args, **kw)
            torch.cuda.synchronize()
            assert _route_counts(f0, wrapper.routes, "wide_mma") == (1, 0)
            _close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,H", [("lstm", H) for H in (160, 288, 512, 608)]
                         + [("gru", H) for H in (160, 352, 512, 640, 672)])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_wide_mma_forward_plan_matches_the_layout(cuda_device, cell, H, B):
    """The forward launchers split H as ``ops/wide_mma_layout.py::plan`` does
    and choose the rows, tiles a warp, K parts and h buffers ``fwd_rows`` replays at
    the card's clusters; B <= 32 runs in one wave, and at H = 512 so does
    B = 160."""
    import ctypes

    from percivaltts_tpu_torch import _build
    from percivaltts_tpu_torch.ops import wide_mma_layout as wm

    gates = 3 if cell == "gru" else 4
    p = wm.plan(H, gates)
    fn = getattr(_build.library(),
                 f"percival_{'bigru' if gates == 3 else 'bilstm'}_fwd_wide_mma_plan")
    out = (ctypes.c_int * 11)()
    assert fn(B, H, p.Hb, p.U, 0, out) == 0
    U, Hb, NC, R, TPW, WPG, KSP, clusters, waves, dbuf, smem = out
    assert (U, Hb, NC) == tuple(p) and clusters >= 1
    assert (R, TPW, WPG, KSP, waves, dbuf, smem) == tuple(wm.fwd_rows(B, H, gates, clusters))
    if B <= 32 or H == 512:
        assert waves == 1
    assert fn(B, H + 8, p.Hb, p.U, 0, out) != 0  # H not a multiple of 32


# --- the DSP kernels: framing × window and overlap-add ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,fl,hop", [(4, 122880, 804, 80), (4, 122880, 800, 80), (1, 122880, 160, 80),
                                        (2, 777, 320, 64), (3, 1000, 400, 80), (1, 5, 160, 80),
                                        (2, 3001, 777, 100), (3, 1001, 804, 80), (2, 1041, 160, 80),
                                        (43, 122880, 160, 80), (2, 1000, 48, 80), (2, 1003, 66, 100),
                                        (1, 50000, 20000, 4000), (4, 122880, 400, 80),
                                        (1, 122880, 400, 80), (8, 16000, 400, 80)])
def test_frame_window_kernel_equals_twin(cuda_device, dtype, B, n, fl, hop):
    """One copy and at most one multiply, rounded once: bit for bit. Edges:
    fl not a multiple of 8 (777, 804, 66), odd n (rows off 16-byte
    alignment), nf not a multiple of the 8-frame tile, B·nf past 65,535,
    fl < hop, and a frame too wide for one block (cut into column slices)."""
    from percivaltts_tpu_torch.ops import frames_cuda
    from percivaltts_tpu_torch.ops.stft import hann_window

    g = torch.Generator(device=cuda_device).manual_seed(n + fl)
    x = torch.randn(B, n, generator=g, device=cuda_device).to(dtype)
    for window in (None, hann_window(fl, device=cuda_device).to(dtype)):
        before = frames_cuda.frame_window.launches
        got = frames_cuda.frame_window(x, fl, hop, window)
        torch.cuda.synchronize()
        assert frames_cuda.frame_window.launches == before + 1
        want = frames_cuda.frame_window_reference(x, fl, hop, window)
        assert got.shape == want.shape == (B, -(-n // hop), fl) and got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nf,fl,hop", [(4, 1536, 160, 80), (1, 1536, 160, 80), (2, 13, 320, 64),
                                         (3, 257, 400, 80), (1, 1, 160, 80), (2, 37, 777, 100),
                                         (3, 41, 126, 63), (43, 1536, 160, 80), (2, 20, 48, 80),
                                         (4, 1536, 400, 80), (1, 1536, 400, 80), (8, 200, 400, 80)])
def test_overlap_add_kernel_equals_twin(cuda_device, dtype, B, nf, fl, hop):
    """The terms summed in the twin's order, each partial sum rounded to the
    dtype: bit for bit. Edges: fl not a multiple of 8 with vectors that
    cross hop blocks (777 / 100), rows off 16-byte alignment (out_length
    2583), B·nf past 65,535, fl < hop."""
    from percivaltts_tpu_torch.ops import frames_cuda

    g = torch.Generator(device=cuda_device).manual_seed(nf + fl)
    frames = torch.randn(B, nf, fl, generator=g, device=cuda_device).to(dtype)
    before = frames_cuda.overlap_add.launches
    got = frames_cuda.overlap_add(frames, hop, nf * hop)
    torch.cuda.synchronize()
    assert frames_cuda.overlap_add.launches == before + 1
    want = frames_cuda.overlap_add_reference(frames, hop, nf * hop)
    assert got.shape == want.shape == (B, nf * hop) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overlap_add_reads_strided_and_broadcast_frames(cuda_device, dtype):
    """A stride-0 broadcast row (the iSTFT's window² normaliser) and frames
    cut from a wider buffer (frame stride 320, batch stride past the frames)
    equal the twin on the materialised copies, bit for bit; the launch runs
    the overlap-add kernel and nothing else (no copy)."""
    from torch.profiler import ProfilerActivity, profile

    from percivaltts_tpu_torch.ops import frames_cuda
    from percivaltts_tpu_torch.ops.stft import hann_window

    w = hann_window(160, device=cuda_device).to(dtype)
    row = (w * w).expand(1, 1536, 160)
    assert row.stride() == (0, 0, 1)
    got = frames_cuda.overlap_add(row, 80, 1536 * 80)
    assert torch.equal(got, frames_cuda.overlap_add_reference(row.contiguous(), 80, 1536 * 80))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    wide = torch.randn(3, 60, 330, generator=g, device=cuda_device).to(dtype)
    cut = wide[:, 3:50, 4:164]
    got = frames_cuda.overlap_add(cut, 80, 47 * 80)
    assert torch.equal(got, frames_cuda.overlap_add_reference(cut.contiguous(), 80, 47 * 80))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frames_cuda.overlap_add(row, 80, 1536 * 80)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "overlap_add" in names[0], names


@pytest.mark.cuda
def test_istft_normaliser_is_a_stride_0_view(cuda_device, monkeypatch):
    """The iSTFT hands the window² row to the overlap-add as a broadcast view
    (stride 0 over the frames), so no copy kernel runs for it."""
    from percivaltts_tpu_torch.ops import frames_cuda, stft

    seen = []
    check = frames_cuda._check_ola_args

    def spy(frames, hop, out_length):  # the wrapper's argument check sees what it launches on
        seen.append(frames.stride())
        return check(frames, hop, out_length)

    monkeypatch.setattr(frames_cuda, "_check_ola_args", spy)
    spec = torch.randn(2, 40, 81, dtype=torch.complex64, device=cuda_device)
    y = stft.istft(spec, 160, 80, 40 * 80)
    torch.cuda.synchronize()
    assert y.shape == (2, 3200) and torch.isfinite(y).all()
    assert len(seen) == 2 and seen[1] == (0, 0, 1)


@pytest.mark.cuda
def test_dsp_kernels_refuse_strides_devices_and_grad(cuda_device):
    from percivaltts_tpu_torch.ops import frames_cuda

    x = torch.randn(2, 1000, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        frames_cuda.frame_window(torch.randn(1000, 2, device=cuda_device).T, 400, 80)
    with pytest.raises(ValueError, match="last axis is contiguous"):
        frames_cuda.overlap_add(torch.randn(2, 160, 13, device=cuda_device).transpose(1, 2), 80, 1000)
    strided = torch.randn(2, 13, 320, device=cuda_device)[:, :, :160]  # last axis contiguous: taken
    assert torch.equal(frames_cuda.overlap_add(strided, 80, 1000),
                       frames_cuda.overlap_add_reference(strided.contiguous(), 80, 1000))
    with pytest.raises(ValueError, match="several devices"):
        frames_cuda.frame_window(x, 400, 80, torch.ones(400))
    with pytest.raises(RuntimeError, match="backward"):
        frames_cuda.overlap_add(torch.randn(2, 13, 160, device=cuda_device, requires_grad=True), 80, 1000)
    with torch.no_grad():
        frames_cuda.overlap_add(torch.randn(2, 13, 160, device=cuda_device, requires_grad=True), 80, 1000)


@pytest.mark.cuda
def test_vocoder_on_the_card_launches_the_dsp_kernels(cuda_device):
    """The default PML vocoder (closed loop, 2 passes) on one 4-utterance
    chunk: 7 framings (3 noise STFTs, YIN and CheapTrick in each of 2
    re-analyses) and 6 overlap-adds (2 per render), finite waveforms of
    nf·80 samples; the same vocode through the twins on the card agrees."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.ops import frames_cuda, stft
    from percivaltts_tpu_torch.vocoders import get_vocoder

    rng = np.random.default_rng(0)
    feats = []
    for nf in (100, 180, 60, 256):
        f = np.zeros((nf, 99), np.float32)
        f[:, 0] = np.log(120.0) + 0.1 * np.sin(np.arange(nf) / 9.0)
        f[:, 1:66] = -6.0 - np.linspace(0, 4, 65) + 0.2 * rng.normal(size=(nf, 65))
        f[:, 66:] = np.where((np.arange(nf) // 40 % 2 == 0)[:, None], 0.2, 1.0)
        feats.append(f)
    voc = get_vocoder(VocoderConfig())
    before = (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches)
    wavs = voc.synthesize_batch(feats)
    launched = (frames_cuda.frame_window.launches - before[0], frames_cuda.overlap_add.launches - before[1])
    assert launched == (7, 6)
    for f, w in zip(feats, wavs):
        assert w.shape == (f.shape[0] * 80,) and np.isfinite(w).all()
    kernels = (stft.frames_cuda.frame_window, stft.frames_cuda.overlap_add)
    try:
        stft.frames_cuda.frame_window = frames_cuda.frame_window_reference
        stft.frames_cuda.overlap_add = frames_cuda.overlap_add_reference
        plain = voc.synthesize_batch(feats)
    finally:
        stft.frames_cuda.frame_window, stft.frames_cuda.overlap_add = kernels
    for w, p in zip(wavs, plain):
        assert np.abs(w - p).max() <= 1e-4 * np.abs(p).max()


def _mel_feats():
    """Four log-mel feature sets (80 mels) of 100–256 frames: one chunk."""
    rng = np.random.default_rng(1)
    return [(-6.0 - np.linspace(0, 5, 80) + 0.5 * rng.normal(size=(nf, 80))).astype(np.float32)
            for nf in (100, 180, 60, 256)]


class _DspTwins:
    """Within the block, the port's framings and overlap-adds run the twins."""

    def __enter__(self):
        from percivaltts_tpu_torch.ops import frames_cuda, stft

        self.kernels = (stft.frames_cuda.frame_window, stft.frames_cuda.overlap_add)
        stft.frames_cuda.frame_window = frames_cuda.frame_window_reference
        stft.frames_cuda.overlap_add = frames_cuda.overlap_add_reference

    def __exit__(self, *exc):
        from percivaltts_tpu_torch.ops import stft

        stft.frames_cuda.frame_window, stft.frames_cuda.overlap_add = self.kernels


@pytest.mark.cuda
def test_griffin_lim_on_the_card_launches_the_dsp_kernels(cuda_device):
    """Config 4's mel vocoder on one 4-utterance chunk (padded to 256
    frames): each of the 64 Griffin-Lim iterations frames once and
    overlap-adds twice (the frames and the window² normaliser), the final
    render twice more: (64, 130) launches, finite waveforms of nf·80
    samples, equal to the same vocode through the twins (0 expected; 1e-4
    of the largest sample)."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.ops import frames_cuda
    from percivaltts_tpu_torch.vocoders import get_vocoder

    feats = _mel_feats()
    voc = get_vocoder(VocoderConfig(kind="melspec"))
    before = (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches)
    wavs = voc.synthesize_batch(feats)
    launched = (frames_cuda.frame_window.launches - before[0], frames_cuda.overlap_add.launches - before[1])
    assert launched == (64, 130)
    for f, w in zip(feats, wavs):
        assert w.shape == (f.shape[0] * 80,) and np.isfinite(w).all()
    with _DspTwins():
        plain = voc.synthesize_batch(feats)
    for w, p in zip(wavs, plain):
        assert np.abs(w - p).max() <= 1e-4 * np.abs(p).max()
    # analysis: one framing, and the same features as the twins'
    before = frames_cuda.frame_window.launches
    got = voc.analyze_batch(wavs)
    assert frames_cuda.frame_window.launches == before + 1
    with _DspTwins():
        for g, p in zip(got, voc.analyze_batch(wavs)):
            assert np.array_equal(g, p)


@pytest.mark.cuda
def test_world_vocoder_on_the_card_launches_the_dsp_kernels(cuda_device):
    """WORLD at ``VocoderConfig(kind="world")`` (closed loop, 2 passes):
    analysis and a copy-synthesis of one chunk launch both DSP kernels and
    equal the same calls through the twins (analysis bit for bit, synthesis
    within 1e-4 of the largest sample)."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.ops import frames_cuda
    from percivaltts_tpu_torch.vocoders import get_vocoder

    t = np.arange(24000) / 16000.0
    rng = np.random.default_rng(2)
    wavs = [(0.4 * np.sin(2 * np.pi * (120 + 20 * k) * t[:n]) * (t[:n] % 0.5 < 0.3)
             + 0.01 * rng.normal(size=n)).astype(np.float32) for k, n in enumerate((9000, 24000, 16000))]
    voc = get_vocoder(VocoderConfig(kind="world"))
    before = (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches)
    feats = voc.analyze_batch(wavs)
    syn = voc.synthesize_batch(feats, seed=1)
    launched = (frames_cuda.frame_window.launches - before[0], frames_cuda.overlap_add.launches - before[1])
    assert launched[0] > 0 and launched[1] > 0, launched
    with _DspTwins():
        for f, p in zip(feats, voc.analyze_batch(wavs)):
            assert np.array_equal(f, p)
        plain = voc.synthesize_batch(feats, seed=1)
    for f, w, p in zip(feats, syn, plain):
        assert w.shape == (f.shape[0] * 80,) and np.isfinite(w).all()
        assert np.abs(w - p).max() <= 1e-4 * np.abs(p).max()


@pytest.mark.cuda
def test_te_vocoder_and_analysis_variants_on_the_card_equal_the_twins(cuda_device):
    """PML's ``envelope="te"``: the analysis frames through the kernel, and
    a copy-synthesis of one chunk renders open loop (closed_loop=2 is
    ignored, as in the JAX package): 1 framing (the noise STFT) and 2
    overlap-adds (the iSTFT's frames and normaliser); both equal the same
    calls through the twins (analysis bit for bit, synthesis within 1e-4 of
    the largest sample). Then WORLD's "te" and each non-default
    ``AnalysisParams`` reader: the analysis through the kernels equals the
    twins' bit for bit."""
    from percivaltts_tpu_torch import VocoderConfig
    from percivaltts_tpu_torch.config import AnalysisParams
    from percivaltts_tpu_torch.ops import frames_cuda
    from percivaltts_tpu_torch.vocoders import get_vocoder

    t = np.arange(24000) / 16000.0
    rng = np.random.default_rng(3)
    wavs = [(0.4 * np.sin(2 * np.pi * (120 + 20 * k) * t[:n]) * (t[:n] % 0.5 < 0.3)
             + 0.01 * rng.normal(size=n)).astype(np.float32) for k, n in enumerate((9000, 24000, 16000))]
    voc = get_vocoder(VocoderConfig(envelope="te", closed_loop=2))
    before = frames_cuda.frame_window.launches
    feats = voc.analyze_batch(wavs)
    assert frames_cuda.frame_window.launches > before
    before = (frames_cuda.frame_window.launches, frames_cuda.overlap_add.launches)
    syn = voc.synthesize_batch(feats, seed=1)
    launched = (frames_cuda.frame_window.launches - before[0], frames_cuda.overlap_add.launches - before[1])
    assert launched == (1, 2)
    with _DspTwins():
        for f, p in zip(feats, voc.analyze_batch(wavs)):
            assert np.array_equal(f, p)
        plain = voc.synthesize_batch(feats, seed=1)
    for f, w, p in zip(feats, syn, plain):
        assert w.shape == (f.shape[0] * 80,) and np.isfinite(w).all()
        assert np.abs(w - p).max() <= 1e-4 * np.abs(p).max()
    for cfg in (VocoderConfig(kind="world", envelope="te"),
                VocoderConfig(analysis=AnalysisParams(ps_reflect=True)),
                VocoderConfig(analysis=AnalysisParams(ps_shift=True, ps_shift_snap=True)),
                VocoderConfig(analysis=AnalysisParams(ps_shift=True, ps_shift_nm_only=True)),
                VocoderConfig(analysis=AnalysisParams(psync=False))):
        voc = get_vocoder(cfg)
        got = voc.analyze_batch(wavs)
        with _DspTwins():
            for g, p in zip(got, voc.analyze_batch(wavs)):
                assert np.array_equal(g, p), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw,launches", [
    (dict(generator="cnn_blstm", conv_style="2d", gen_norm="layer", critic_norm="layer"), (2, 1)),
    (dict(generator="bgru", gen_norm="layer"), (4, 2)),
])
def test_variant_wgan_step_on_the_card_launches_the_kernels(cuda_device, model_kw, launches):
    """One WGAN-GP step at small width of the reference-faithful model (2d
    generator and critic, LayerNorms) and of the BGRU with its LayerNorm:
    finite metrics and (forward, BPTT) launches a step on the tensor-core
    route, (2, 1) and (4, 2)."""
    import dataclasses

    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = Configuration(
        data=DataConfig(batch_size=4, bucket_bounds=(64,), label_dim=13),
        vocoder=VocoderConfig(spec_size=17, nm_size=9),
        model=dataclasses.replace(ModelConfig(**model_kw), hidden_size=32, blstm_size=64,
                                  cnn_channels=8, critic_channels=8, critic_hidden=32,
                                  critic_blocks=2),
        train=TrainConfig(n_critic=2),
    )
    state = make_gan_state(cfg, 13, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    batch = lambda *lead: {  # noqa: E731
        "lab": torch.randn(*lead, 4, 64, 13, generator=g, device=cuda_device),
        "cmp": torch.randn(*lead, 4, 64, 27, generator=g, device=cuda_device),
        "mask": torch.ones(*lead, 4, 64, device=cuda_device),
    }
    fwd, bwd = (bigru_fwd, bigru_bwd) if model_kw["generator"] == "bgru" else (bilstm_fwd, bilstm_bwd)
    f0, b0 = fwd.routes["mma"], bwd.routes["mma"]
    state, m = make_wgan_step(cfg.train)(state, batch(2), batch())
    torch.cuda.synchronize()
    assert (fwd.routes["mma"] - f0, bwd.routes["mma"] - b0) == launches
    assert all(torch.isfinite(v).item() for v in m.values())


# --- the training loop and checkpoints ---------------------------------------


def _loop_cfg(workdir, **train_kw):
    """Small widths, bf16 compute (the tensor-core routes at H=32), WGAN-GP
    with 2 critic updates, an EMA, batches of 4 in two buckets."""
    import dataclasses

    from percivaltts_tpu_torch import (Configuration, DataConfig, ModelConfig, TrainConfig,
                                       VocoderConfig)

    return Configuration(
        workdir=str(workdir),
        data=DataConfig(batch_size=4, bucket_bounds=(32, 64), label_dim=13),
        vocoder=VocoderConfig(spec_size=17, nm_size=9),
        model=dataclasses.replace(ModelConfig(generator="cnn_blstm"), hidden_size=32,
                                  blstm_size=64, critic_hidden=32, critic_blocks=2,
                                  dropout_rate=0.1),
        train=TrainConfig(n_critic=2, ema_decay=0.9, profile_steps=1, **train_kw),
    )


def _loop_data(n, seed):
    from percivaltts_tpu_torch.data.dataset import Dataset

    rng = np.random.default_rng(seed)
    labs = [rng.normal(size=(int(k), 13)).astype(np.float32) for k in rng.integers(20, 90, n)]
    return Dataset(labs, [rng.normal(size=(a.shape[0], 27)).astype(np.float32) for a in labs])


@pytest.mark.cuda
def test_trainer_runs_an_epoch_on_the_card(cuda_device, tmp_path):
    """One WGAN-GP epoch of the ``Trainer`` with its default device: finite
    records, (2 forward, 1 BPTT) launches a step on the tensor-core route
    plus 1 forward a validation batch, a checkpoint and a Chrome trace."""
    import json
    import os

    from percivaltts_tpu_torch.training import Trainer

    train, valid = _loop_data(48, seed=0), _loop_data(6, seed=1)
    trainer = Trainer(_loop_cfg(tmp_path), train, valid)
    assert next(trainer.state.gen.parameters()).device.type == "cuda"
    n_valid = len(list(valid.batches(4, (32, 64), shuffle=False, drop_remainder=False)))
    f0, b0, r0 = bilstm_fwd.launches, bilstm_bwd.launches, bilstm_fwd.routes["simt"]
    hist = trainer.train(epochs=1)
    trainer.close()
    torch.cuda.synchronize()
    (rec,) = hist["train"]
    assert rec["steps"] > 0 and all(np.isfinite(v) for v in rec.values())
    assert np.isfinite(hist["valid"][0])
    assert bilstm_fwd.launches - f0 == 2 * rec["steps"] + n_valid
    assert bilstm_bwd.launches - b0 == rec["steps"]
    assert bilstm_fwd.routes["simt"] == r0
    assert trainer.ckpt.all_steps() == [0]
    (trace,) = os.listdir(tmp_path / "traces")
    with open(tmp_path / "traces" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_checkpoint_round_trips_on_the_card(cuda_device, tmp_path):
    """Save → restore on the card, bit for bit: both nets, both Adam states
    (their step counters back on the host), the CUDA step generator's
    state, the counters and the EMA; then the same step from both states
    gives the same metrics."""
    from percivaltts_tpu_torch.training.checkpoints import CheckpointManager
    from percivaltts_tpu_torch.training.state import make_gan_state
    from percivaltts_tpu_torch.training.wgan import make_wgan_step

    cfg = _loop_cfg(tmp_path)
    state = make_gan_state(cfg, 13, seed=0)
    step = make_wgan_step(cfg.train)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batch = lambda *lead: {  # noqa: E731
        "lab": torch.randn(*lead, 4, 64, 13, generator=g, device=cuda_device),
        "cmp": torch.randn(*lead, 4, 64, 27, generator=g, device=cuda_device),
        "mask": torch.ones(*lead, 4, 64, device=cuda_device),
    }
    for _ in range(2):
        state, _ = step(state, batch(2), batch())
    state.epoch = 3
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(2, state, metrics={"score": 0.5})
    restored = mgr.restore(make_gan_state(cfg, 13, seed=7))

    def equal(a, b, path):
        if isinstance(a, torch.Tensor):
            assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), path
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                equal(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                equal(x, y, f"{path}/{i}")
        else:
            assert a == b, path

    equal(restored.state_dict(), state.state_dict(), "state")
    assert all(st["step"].device.type == "cpu" for st in restored.gen_opt.state.values())
    b = (batch(2), batch())
    _, m1 = step(state, *b)
    _, m2 = step(restored, *b)
    equal(m2, m1, "metrics")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_corpus_gathers_on_the_card(cuda_device, dtype):
    """The corpus resident on the card equals the one built on the CPU bit
    for bit (the bf16 cast happens on the host), and each gathered batch
    equals the CPU gather; the index array is the only copy a step."""
    from percivaltts_tpu_torch.data.dataset import Dataset
    from percivaltts_tpu_torch.data.device_corpus import DeviceCorpus, gather_batch

    rng = np.random.default_rng(3)
    lengths = rng.integers(20, 140, size=37)
    ds = Dataset([rng.normal(size=(n, 13)).astype(np.float32) for n in lengths],
                 [rng.normal(size=(n, 27)).astype(np.float32) for n in lengths])
    card = DeviceCorpus(ds, bound=128, dtype=dtype, device=cuda_device)
    host = DeviceCorpus(ds, bound=128, dtype=dtype, device="cpu")
    for k in card.data:
        assert card.data[k].device.type == "cuda" and torch.equal(card.data[k].cpu(), host.data[k])
    for idx in card.epoch_indices(4, 6, epoch=1, seed=2, num_steps=3):
        got = gather_batch(card.data, card.shard_indices(idx))
        want = gather_batch(host.data, host.shard_indices(idx))
        for k in got:
            assert got[k].shape == (6, 4, 128) + want[k].shape[3:]
            assert torch.equal(got[k].cpu(), want[k]), k
        assert got["mask"].dtype == torch.float32


@pytest.mark.cuda
def test_compose_through_the_kernels_equals_the_twins(cuda_device, tmp_path, monkeypatch):
    """Compose of a 10-utterance demo corpus at the default vocoder (99
    features) on the card: the framing kernel launches, and the composed
    features and stats equal, bit for bit, a compose of the same wavs with
    every framing and overlap-add on the twins."""
    from percivaltts_tpu_torch.config import Configuration
    from percivaltts_tpu_torch.data.compose import compose
    from percivaltts_tpu_torch.data.demo import generate_demo_corpus
    from percivaltts_tpu_torch.ops import frames_cuda as fc

    root = str(tmp_path / "demo")
    generate_demo_corpus(root, num_utterances=10, seed=4)
    d = Configuration(workdir=str(tmp_path / "exp")).to_dict()
    d["data"].update(corpus_dir=root, fileids=f"{root}/fileids.scp",
                     question_file=f"{root}/questions.hed", num_valid=2, num_test=2)
    cfg = Configuration.from_dict(d)
    fc.frame_window.launches = 0
    got = compose(cfg, device=cuda_device)
    assert fc.frame_window.launches > 0 and got.train.feat_dim == 99
    monkeypatch.setattr(fc, "frame_window", fc.frame_window_reference)
    monkeypatch.setattr(fc, "overlap_add", fc.overlap_add_reference)
    want = compose(cfg, device=cuda_device)
    for name in ("in_stats", "out_stats"):
        assert np.array_equal(getattr(got, name).shift, getattr(want, name).shift)
        assert np.array_equal(getattr(got, name).scale, getattr(want, name).scale)
    for split in ("train", "valid", "test"):
        for a, b in zip(getattr(got, split).cmps, getattr(want, split).cmps):
            assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fwd,per_call,tol", [("cnn_blstm", "bilstm_fwd", 1, 0.0625),
                                                   ("bgru", "bigru_fwd", 2, 0.125)])
def test_exported_generator_launches_the_kernel_and_equals_live(cuda_device, tmp_path, kind, fwd,
                                                                 per_call, tol):
    """``chip_smoke.py`` phase 11a at a small width (bf16, H = 16 / 32: the
    tensor-core route): artifacts at bounds 32 and 64, batch 1 and 4,
    reloaded on the card; every row equals the live generator on the same
    bucket-bound padded batch bit for bit; the forward kernel launches
    inside the artifact calls; the artifact moved to the CPU serves
    within phase 4's tolerance of the card (the twins there)."""
    from percivaltts_tpu_torch.config import ModelConfig, VocoderConfig
    from percivaltts_tpu_torch.data.normalize import NormStats
    from percivaltts_tpu_torch.eval.export import ExportedGenerator, export_generator, write_export
    from percivaltts_tpu_torch.models import build_generator
    from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda

    D, voc = 13, VocoderConfig(spec_size=17, nm_size=9)
    gen = build_generator(ModelConfig(generator=kind, hidden_size=64, cnn_blocks=1, blstm_size=32),
                          voc, D).to(cuda_device).eval()
    rng = np.random.default_rng(0)
    ins = NormStats(shift=rng.normal(size=D).astype(np.float32),
                    scale=rng.uniform(0.5, 2.0, D).astype(np.float32))
    outs = NormStats(shift=rng.normal(size=voc.feature_size).astype(np.float32),
                     scale=rng.uniform(0.5, 2.0, voc.feature_size).astype(np.float32))
    labs = [rng.normal(size=(n, D)).astype(np.float32) for n in (20, 40, 64, 7, 33)]
    wrapper = {"bilstm_fwd": lstm_cuda.bilstm_fwd, "bigru_fwd": gru_cuda.bigru_fwd}[fwd]
    for batch in (1, 4):
        d = str(tmp_path / f"b{batch}")
        write_export(d, export_generator(gen, ins, outs, D, (32, 64), batch=batch), D,
                     voc.feature_size, {"kind": "pml"}, batch=batch)
        ex = ExportedGenerator(d, device=cuda_device)
        groups = ex.groups(labs)
        wrapper.launches, wrapper.routes = 0, dict.fromkeys(wrapper.routes, 0)
        got = ex.predict_batch(labs)
        torch.cuda.synchronize()
        assert wrapper.launches == wrapper.routes["mma"] == per_call * len(groups)
        for bound, group in groups:
            x = np.zeros((batch, bound, D), np.float32)
            for r, j in enumerate(group):
                x[r, : len(labs[j])] = ins.normalize(labs[j])
            with torch.inference_mode():
                y = gen(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
            for r, j in enumerate(group):
                assert np.array_equal(got[j], outs.denormalize(y[r, : len(labs[j])]))
        on_cpu = ExportedGenerator(d, device="cpu").predict_batch(labs)
        for a, b in zip(on_cpu, got):
            np.testing.assert_allclose(a, b, atol=tol)
