"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.) Tolerances: f32
1e-4 (sums and transcendentals in another order); bf16 2e-2 (bf16 outputs,
and h rounded to bf16 before each product, so a one-ulp flip is carried).
"""

import numpy as np
import pytest
import torch

from percivaltts_tpu_torch.ops.lstm_cuda import bilstm, bilstm_fwd, bilstm_fwd_reference


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
    with pytest.raises(ValueError, match="H <= 256"):
        bilstm_fwd(*_gates(2, 1, 264, torch.float32, cuda_device, seed=3))
    args[2].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        bilstm_fwd(*args)
