"""The port's BiLSTM backward against the JAX package's.

``bilstm_bwd_reference`` (the BPTT kernel's plain twin) against the Pallas
BPTT kernel in interpret mode; the autograd function against ``jax.vjp`` of
the ``bilstm_core`` custom VJP; the port's ``BiLSTM`` gradients against JAX
``BiLSTM`` on its scan path; the wrapper's dispatch and checks. The CUDA
kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py``).

f32 tolerance 1e-5: the same math with sums in another order. bf16: dz is
rounded to bf16 and fed back through dh, so a one-ulp rounding flip is
carried into earlier frames; 2e-2 of max|dgx|.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import functools

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
    bilstm_bwd,
    bilstm_bwd_reference,
    bilstm_core,
    bilstm_core_reference,
    bilstm_fwd_reference,
)

SHAPES = [(16, 2, 32), (15, 3, 32)]  # (T, B, H); 15 is odd: the K=1 Pallas grid
# the Pallas kernel in interpret mode, as the JAX package's tests run it on
# the CPU; jitted, which traces each grid once instead of dispatching it
_pallas_bwd = jax.jit(functools.partial(lstm_pallas._bilstm_bwd_pallas, interpret=True))


def _bwd_inputs(T, B, H, seed):
    """gx, W_h and dy per direction, random."""
    rng = np.random.default_rng(seed)
    gx_f, gx_b = rng.normal(size=(2, T, B, 4 * H)).astype(np.float32)
    wh_f, wh_b = (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dy_f, dy_b = rng.normal(size=(2, T, B, H)).astype(np.float32)
    return gx_f, gx_b, wh_f, wh_b, dy_f, dy_b


def _prev_states(yf, yb, cf, cb):
    """h_prev/c_prev per direction (t−1 forward, t+1 backward), as the
    custom VJP builds them."""
    z = np.zeros_like(yf[:1])
    return (np.concatenate([z, yf[:-1]]), np.concatenate([yb[1:], z]),
            np.concatenate([z, cf[:-1]]), np.concatenate([cb[1:], z]))


@functools.cache
def _jax_core(T, B, H):
    """Inputs, and ``jax.vjp`` of ``bilstm_core`` on them (the Pallas pair in
    interpret mode, f32): (yf, yb), the forward's cells (cf, cb), and the
    cotangents (dgx_f, dgx_b, dW_h_f, dW_h_b), whose dgx are the BPTT
    kernel's outputs. One compile serves the f32 tests of a shape."""
    inputs = _bwd_inputs(T, B, H, seed=T)

    @jax.jit
    def run(gx_f, gx_b, wh_f, wh_b, dy_f, dy_b):
        ys, vjp = jax.vjp(lambda *a: lstm_pallas.bilstm_core(*a, True), gx_f, gx_b, wh_f, wh_b)
        cells = lstm_pallas._bilstm_fwd_pallas(gx_f, gx_b, wh_f, wh_b, True)[2:]
        return ys, cells, vjp((dy_f, dy_b))

    return inputs, jax.tree.map(np.array, run(*map(jnp.asarray, inputs)))  # writable


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_bwd_reference_matches_pallas_kernel(T, B, H):
    (gx_f, gx_b, wh_f, wh_b, dy_f, dy_b), ((yf, yb), (cf, cb), want) = _jax_core(T, B, H)
    args = (gx_f, gx_b, wh_f, wh_b, *_prev_states(yf, yb, cf, cb), cf, cb, dy_f, dy_b)
    got = bilstm_bwd_reference(*map(torch.from_numpy, args))
    for g, w in zip(got, want[:2]):
        assert g.shape == (T, B, 4 * H)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_bwd_reference_bf16_rounds_like_pallas_kernel(T, B, H):
    """Both versions on identical bf16 inputs; the states come from the
    twin's forward (only the BPTT is compared, and a bf16 Pallas forward
    would cost another compile)."""
    gx_f, gx_b, wh_f, wh_b, dy_f, dy_b = _bwd_inputs(T, B, H, seed=50 + T)
    bf16 = [torch.from_numpy(a).bfloat16() for a in (gx_f, gx_b, wh_f, wh_b)]
    states = [s.float().numpy() for s in bilstm_fwd_reference(*bf16, with_cells=True)]
    args = (gx_f, gx_b, wh_f, wh_b, *_prev_states(*states), *states[2:], dy_f, dy_b)
    want = _pallas_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    got = bilstm_bwd_reference(*(torch.from_numpy(a).bfloat16() for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_autograd_function_matches_jax_vjp(T, B, H):
    (gx_f, gx_b, wh_f, wh_b, dy_f, dy_b), ((yf_j, yb_j), _, want) = _jax_core(T, B, H)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (gx_f, gx_b, wh_f, wh_b)]
    yf, yb = bilstm_core(*leaves)
    np.testing.assert_allclose(yf.detach().numpy(), yf_j, atol=1e-5)
    np.testing.assert_allclose(yb.detach().numpy(), yb_j, atol=1e-5)
    torch.autograd.backward((yf, yb), (torch.from_numpy(dy_f), torch.from_numpy(dy_b)))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5)


def test_autograd_function_twin_equals_kernel_route_on_cpu():
    """On CPU tensors the kernel route takes the twins, so both cores agree
    exactly; an output that feeds nothing gets a zero gradient."""
    gx_f, gx_b, wh_f, wh_b, dy_f, _ = _bwd_inputs(9, 2, 8, seed=3)
    grads = []
    for core in (bilstm_core, bilstm_core_reference):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (gx_f, gx_b, wh_f, wh_b)]
        yf, _ = core(*leaves)
        (yf * torch.from_numpy(dy_f)).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert not grads[0][1].any() and not grads[0][3].any()  # yb unused


def test_core_without_grad_runs_the_forward_only():
    arrays = [torch.from_numpy(a) for a in _bwd_inputs(6, 2, 8, seed=4)[:4]]
    yf, yb = bilstm_core(*arrays)
    wf, wb = bilstm_fwd_reference(*arrays)
    assert yf.grad_fn is None and torch.equal(yf, wf) and torch.equal(yb, wb)


@pytest.mark.parametrize("T,B,D,H", [(12, 2, 5, 8), (15, 3, 7, 16)])
def test_port_bilstm_grads_match_jax_scan(T, B, D, H):
    rng = np.random.default_rng(T + D)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    jm = JaxBiLSTM(H, compute_dtype="float32", use_pallas=False)
    params = jax.jit(jm.init)(jax.random.key(T), jnp.asarray(x))

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx) * jnp.asarray(dy))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    tm = BiLSTM(D, H, compute_dtype="float32")
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    # the JAX gradients laid out as the port's parameters
    want = BiLSTM(D, H, compute_dtype="float32")
    weights.load_flax_params(want, jax.tree.map(np.asarray, gp))
    for (name, p), w in zip(tm.named_parameters(), want.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(), atol=1e-5, err_msg=name)


def test_bwd_cpu_takes_the_reference_and_leaves_the_counter():
    gx_f, gx_b, wh_f, wh_b, dy_f, dy_b = (torch.from_numpy(a) for a in _bwd_inputs(7, 2, 8, seed=5))
    yf, yb, cf, cb = bilstm_fwd_reference(gx_f, gx_b, wh_f, wh_b, with_cells=True)
    hp_f, hp_b, cp_f, cp_b = (torch.from_numpy(a) for a in _prev_states(
        *(t.numpy() for t in (yf, yb, cf, cb))))
    args = (gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, cf, cb, dy_f, dy_b)
    got = bilstm_bwd(*args)
    want = bilstm_bwd_reference(*args)
    assert bilstm_bwd.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        bilstm_bwd(*args[:4], hp_f[:-1], *args[5:])
    with pytest.raises(TypeError):
        bilstm_bwd(*args[:11], dy_b.double())
