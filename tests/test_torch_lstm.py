"""The port's BiLSTM recurrence against the JAX package's.

``bilstm_fwd_reference`` (the kernel's plain twin) against the Pallas
forward kernel run in interpret mode, the port's ``BiLSTM`` module against
JAX ``BiLSTM`` on its scan path, and the wrapper's dispatch and checks. The
CUDA kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py``).

f32 tolerance 1e-5: the same math with sums in another order. The JAX scan
path carries in the compute dtype while the kernel carries in f32, so the
scan is compared in f32 only; bf16 is compared with the Pallas kernel.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.models.rnn import BiLSTM as JaxBiLSTM
from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models.rnn import BiLSTM
from percivaltts_tpu_torch.ops.lstm_cuda import (
    bilstm_fwd,
    bilstm_fwd_reference,
    rows_per_block,
)

SHAPES = [(16, 2, 32), (15, 3, 32)]  # (T, B, H); 15 is odd: the K=1 Pallas grid


def _gates(T, B, H, seed):
    rng = np.random.default_rng(seed)
    gx_f, gx_b = rng.normal(size=(2, T, B, 4 * H)).astype(np.float32)
    wh_f, wh_b = (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return gx_f, gx_b, wh_f, wh_b


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_reference_matches_pallas_core(T, B, H):
    arrays = _gates(T, B, H, seed=T)
    yf_j, yb_j = lstm_pallas.bilstm_core(*map(jnp.asarray, arrays), True)
    yf, yb = bilstm_fwd_reference(*_torch(*arrays))
    np.testing.assert_allclose(yf.numpy(), np.asarray(yf_j), atol=1e-5)
    np.testing.assert_allclose(yb.numpy(), np.asarray(yb_j), atol=1e-5)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_reference_cells_match_pallas_kernel(T, B, H):
    arrays = _gates(T, B, H, seed=100 + T)
    want = lstm_pallas._bilstm_fwd_pallas(*map(jnp.asarray, arrays), interpret=True)
    got = bilstm_fwd_reference(*_torch(*arrays), with_cells=True)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_reference_bf16_rounds_like_pallas_kernel():
    """In bf16 both round h to bf16 before the recurrent product and carry
    h, c in f32; outputs are bf16, so they may differ by a rounding flip
    that the next steps carry (a few bf16 ulps at |y| < 1)."""
    T, B, H = 16, 2, 32
    arrays = _gates(T, B, H, seed=7)
    want = lstm_pallas._bilstm_fwd_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), interpret=True
    )
    got = bilstm_fwd_reference(*_torch(*arrays, dtype=torch.bfloat16), with_cells=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), atol=2e-2
        )


@pytest.mark.parametrize("T,B,D,H", [(12, 2, 5, 8), (15, 3, 7, 16)])
def test_port_bilstm_matches_jax_scan(T, B, D, H):
    rng = np.random.default_rng(T + D)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jm = JaxBiLSTM(H, compute_dtype="float32", use_pallas=False)
    params = jm.init(jax.random.key(T), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))

    tm = BiLSTM(D, H, compute_dtype="float32")
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cpu_tensors_take_the_reference_and_leave_the_counter():
    arrays = _torch(*_gates(9, 2, 8, seed=3))
    before = bilstm_fwd.launches
    got = bilstm_fwd(*arrays, with_cells=True)
    want = bilstm_fwd_reference(*arrays, with_cells=True)
    assert bilstm_fwd.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda a: [a[0].half(), a[1].half(), a[2].half(), a[3].half()], TypeError),
        (lambda a: [a[0], a[1].double(), a[2], a[3]], TypeError),
        (lambda a: [a[0], a[1][:-1], a[2], a[3]], ValueError),
        (lambda a: [a[0], a[1], a[2][:, :-4], a[3]], ValueError),
        (lambda a: [a[0][..., :-1], a[1][..., :-1], a[2], a[3]], ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(change, err):
    arrays = _torch(*_gates(4, 2, 8, seed=1))
    with pytest.raises(err):
        bilstm_fwd(*change(arrays))


def test_rows_per_block_keeps_one_wave():
    assert rows_per_block(8, 132) == 1  # serving chunk: 16 blocks
    assert rows_per_block(1, 132) == 1
    assert rows_per_block(160, 132) == 4  # 80 blocks
    assert rows_per_block(4000, 132) == 8  # more than one wave at any tile
