"""The port's BiGRU recurrence against the JAX package's.

The plain twins of the forward and BPTT kernels against the Pallas GRU
kernels in interpret mode (as ``tests/test_rnn.py`` runs them on the CPU);
``bigru_core_reference``'s gradients against ``jax.vjp`` of the
``bigru_core`` custom VJP; ``BiLSTM(cell_type="gru")`` against the JAX module
on its Pallas path in interpret mode; the wrappers' dispatch and checks; the
recurrent generators' dropout. The CUDA kernels themselves are held against
the twins on the card (``tests/test_torch_cuda.py``).

f32 tolerance 1e-5: the same math with sums in another order. bf16: the
outputs are bf16 and h is rounded to bf16 before each product, so a one-ulp
rounding flip is carried into later steps: 2e-2 absolute on y (|y| < 1);
in the BPTT the d(gates) are rounded to bf16 and fed back through dh, so
2e-2 of max|dgx| (or max|dnr|).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.models.rnn import BiLSTM as JaxBiLSTM
from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch import ModelConfig, VocoderConfig, weights
from percivaltts_tpu_torch.models import build_generator
from percivaltts_tpu_torch.models.generators import _dense, dropout
from percivaltts_tpu_torch.models.rnn import BiLSTM
from percivaltts_tpu_torch.ops.gru_cuda import (
    bigru,
    bigru_bwd,
    bigru_bwd_reference,
    bigru_core,
    bigru_core_reference,
    bigru_fwd,
    bigru_fwd_reference,
)

SHAPES = [(16, 2, 32), (15, 3, 32)]  # (T, B, H); 15 is odd: another Pallas time block
_pallas_fwd = jax.jit(functools.partial(lstm_pallas._bigru_fwd_pallas, interpret=True))
_pallas_bwd = jax.jit(functools.partial(lstm_pallas._bigru_bwd_pallas, interpret=True))


def _inputs(T, B, H, seed):
    """gx, W_h, b_hn and dy per direction, random."""
    rng = np.random.default_rng(seed)
    gx_f, gx_b = rng.normal(size=(2, T, B, 3 * H)).astype(np.float32)
    wh_f, wh_b = (rng.normal(size=(2, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    bn_f, bn_b = rng.normal(size=(2, H)).astype(np.float32)
    dy_f, dy_b = rng.normal(size=(2, T, B, H)).astype(np.float32)
    return gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b


def _prev(yf, yb):
    """h_prev per direction (t−1 forward, t+1 backward) from the outputs, as
    the custom VJP builds it."""
    z = np.zeros_like(yf[:1])
    return np.concatenate([z, yf[:-1]]), np.concatenate([yb[1:], z])


@functools.cache
def _jax_core(T, B, H):
    """Inputs, and on them (the Pallas kernels in interpret mode, f32):
    ``jax.vjp`` of ``bigru_core`` — (yf, yb) and the cotangents (dgx_f,
    dgx_b, dW_h_f, dW_h_b, db_hn_f, db_hn_b) — and the BPTT kernel's own
    outputs (dgx_f, dgx_b, dnr_f, dnr_b). One compile serves the f32 tests
    of a shape."""
    inputs = _inputs(T, B, H, seed=T)

    @jax.jit
    def run(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b):
        ys, vjp = jax.vjp(lambda *a: lstm_pallas.bigru_core(*a, True),
                          gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
        z = jnp.zeros_like(ys[0][:1])
        hp_f = jnp.concatenate([z, ys[0][:-1]])
        hp_b = jnp.concatenate([ys[1][1:], z])
        bwd = lstm_pallas._bigru_bwd_pallas(gx_f, gx_b, wh_f, wh_b, bn_f, bn_b,
                                            hp_f, hp_b, dy_f, dy_b, True)
        return ys, vjp((dy_f, dy_b)), bwd

    return inputs, jax.tree.map(np.array, run(*map(jnp.asarray, inputs)))  # writable


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_fwd_reference_matches_pallas_kernel(T, B, H):
    inputs, ((yf_j, yb_j), _, _) = _jax_core(T, B, H)
    yf, yb = bigru_fwd_reference(*map(torch.from_numpy, inputs[:6]))
    assert yf.shape == yb.shape == (T, B, H)
    np.testing.assert_allclose(yf.numpy(), yf_j, atol=1e-5)
    np.testing.assert_allclose(yb.numpy(), yb_j, atol=1e-5)


def test_fwd_reference_bf16_rounds_like_pallas_kernel():
    """In bf16 both round h to bf16 before the recurrent product and carry
    h in f32."""
    inputs = _inputs(16, 2, 32, seed=7)[:6]
    want = _pallas_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in inputs))
    got = bigru_fwd_reference(*(torch.from_numpy(a).bfloat16() for a in inputs))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=2e-2)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_bwd_reference_matches_pallas_kernel(T, B, H):
    (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b), ((yf, yb), _, want) = _jax_core(T, B, H)
    args = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, *_prev(yf, yb), dy_f, dy_b)
    got = bigru_bwd_reference(*map(torch.from_numpy, args))
    for name, g, w in zip(("dgx_f", "dgx_b", "dnr_f", "dnr_b"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)


def test_bwd_reference_bf16_rounds_like_pallas_kernel():
    """Both versions on identical bf16 inputs: h_prev is the bf16 output of
    the twin's forward (the Pallas BPTT reads the rounded y, not the f32
    carry), so only the BPTT is compared."""
    gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b = _inputs(16, 2, 32, seed=57)
    bf16 = [torch.from_numpy(a).bfloat16() for a in (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)]
    ys = [y.float().numpy() for y in bigru_fwd_reference(*bf16)]
    args = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, *_prev(*ys), dy_f, dy_b)
    want = _pallas_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    got = bigru_bwd_reference(*(torch.from_numpy(a).bfloat16() for a in args))
    for name, g, w in zip(("dgx_f", "dgx_b", "dnr_f", "dnr_b"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 2e-2 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_core_reference_grads_match_jax_vjp(T, B, H):
    """dgx, dW_h (which reads dnr for the n branch, not dn_pre) and db_hn
    (Σ dnr) of the autograd function on the twins."""
    inputs, ((yf_j, yb_j), want, _) = _jax_core(T, B, H)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs[:6]]
    yf, yb = bigru_core_reference(*leaves)
    np.testing.assert_allclose(yf.detach().numpy(), yf_j, atol=1e-5)
    np.testing.assert_allclose(yb.detach().numpy(), yb_j, atol=1e-5)
    torch.autograd.backward((yf, yb), tuple(map(torch.from_numpy, inputs[6:])))
    names = ("dgx_f", "dgx_b", "dW_h_f", "dW_h_b", "db_hn_f", "db_hn_b")
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5, err_msg=name)


def test_autograd_function_twin_equals_kernel_route_on_cpu():
    """On CPU tensors the kernel route takes the twins, so both cores agree
    exactly; an output that feeds nothing gets a zero gradient."""
    inputs = _inputs(9, 2, 8, seed=3)
    grads = []
    for core in (bigru_core, bigru_core_reference):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs[:6]]
        yf, _ = core(*leaves)
        (yf * torch.from_numpy(inputs[6])).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert not grads[0][1].any() and not grads[0][3].any() and not grads[0][5].any()  # yb unused


def test_core_without_grad_runs_the_forward_only():
    arrays = [torch.from_numpy(a) for a in _inputs(6, 2, 8, seed=4)[:6]]
    yf, yb = bigru_core(*arrays)
    wf, wb = bigru_fwd_reference(*arrays)
    assert yf.grad_fn is None and torch.equal(yf, wf) and torch.equal(yb, wb)


def test_cpu_tensors_take_the_references_and_leave_the_counters():
    gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b = map(torch.from_numpy, _inputs(7, 2, 8, seed=5))
    fwd_args = (gx_f, gx_b, wh_f, wh_b, bn_f, bn_b)
    for g, w in zip(bigru_fwd(*fwd_args), bigru_fwd_reference(*fwd_args)):
        assert torch.equal(g, w)
    yf, yb = bigru_fwd_reference(*fwd_args)
    z = torch.zeros_like(yf[:1])
    args = (*fwd_args, torch.cat([z, yf[:-1]]), torch.cat([yb[1:], z]), dy_f, dy_b)
    for g, w in zip(bigru_bwd(*args), bigru_bwd_reference(*args)):
        assert torch.equal(g, w)
    assert bigru_fwd.launches == bigru_bwd.launches == 0


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda a: [t.half() for t in a], TypeError),
        (lambda a: [a[0], a[1].double(), *a[2:]], TypeError),
        (lambda a: [a[0], a[1][:-1], *a[2:]], ValueError),
        (lambda a: [*a[:2], a[2][:, :-3], *a[3:]], ValueError),
        (lambda a: [*a[:5], a[5][:-1]], ValueError),
        (lambda a: [a[0][..., :-1], a[1][..., :-1], *a[2:]], ValueError),
    ],
)
def test_wrappers_reject_bad_inputs(change, err):
    gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, dy_f, dy_b = map(torch.from_numpy, _inputs(4, 2, 8, seed=1))
    fwd_args = [gx_f, gx_b, wh_f, wh_b, bn_f, bn_b]
    with pytest.raises(err):
        bigru_fwd(*change(fwd_args))
    with pytest.raises(err):
        bigru_bwd(*change(fwd_args), dy_f, dy_b, dy_f, dy_b)
    with pytest.raises(ValueError):  # a state of another shape
        bigru_bwd(*fwd_args, dy_f[:-1], dy_b, dy_f, dy_b)
    with pytest.raises(TypeError):  # a state of another dtype
        bigru_bwd(*fwd_args, dy_f, dy_b, dy_f, dy_b.double())


def _jax_gru_module(x, H, seed):
    jm = JaxBiLSTM(H, compute_dtype="float32", cell_type="gru", use_pallas=True,
                   pallas_interpret=True)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))
    return jm, params


def test_port_bigru_matches_jax_pallas_module():
    """``BiLSTM(cell_type="gru")`` against the JAX module on its Pallas
    path, same weights: outputs, the input gradient and every parameter's
    gradient (the n-branch bias ``bhn`` included)."""
    T, B, D, H = 12, 2, 5, 8
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    jm, params = _jax_gru_module(x, H, seed=2)
    # a nonzero n-branch bias, so the test sees where it enters
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.3 if p[-1].key == "bhn" else v, params)

    def loss(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    tm = BiLSTM(D, H, compute_dtype="float32", cell_type="gru")
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    (got * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    ref = BiLSTM(D, H, compute_dtype="float32", cell_type="gru")  # the JAX grads, port layout
    weights.load_flax_params(ref, jax.tree.map(np.asarray, gp))
    for (name, p), w in zip(tm.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(), atol=1e-5, err_msg=name)


def test_bigru_layer_computes_what_torch_gru_computes():
    """``torch.nn.GRU(bidirectional=True)``, the yardstick the card run
    times beside the kernels (the port never calls it), computes the same
    function: gate order r, z, n and b_hn inside r ⊙ (…). f32, 1e-5."""
    B, T, D, H = 3, 10, 6, 8
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(B, T, D)).astype(np.float32))
    p = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.5)
         for s in ((D, 3 * H), (H, 3 * H), (3 * H,), (H,)) * 2]
    with torch.no_grad():
        got = bigru(x, *p)
        lib = torch.nn.GRU(D, H, batch_first=True, bidirectional=True)
        for sfx, (wi, wh, b, bn) in (("", p[:4]), ("_reverse", p[4:])):
            getattr(lib, f"weight_ih_l0{sfx}").copy_(wi.T)
            getattr(lib, f"weight_hh_l0{sfx}").copy_(wh.T)
            getattr(lib, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lib, f"bias_hh_l0{sfx}").copy_(torch.cat([torch.zeros(2 * H), bn]))
        want, _ = lib(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_gru_params_follow_flax_init_rules():
    m = BiLSTM(256, 128, cell_type="gru", generator=torch.Generator().manual_seed(3))
    H = 128
    for d in (m.fwd, m.bwd):
        assert tuple(d.wi.shape) == (256, 3 * H) and tuple(d.bn.shape) == (H,)
        assert abs(d.wi.detach().double().std().item() * np.sqrt(256) - 1.0) < 0.02
        for k in range(3):
            q = d.wh.detach().double()[:, k * H : (k + 1) * H]
            assert torch.allclose(q.T @ q, torch.eye(H, dtype=q.dtype), atol=1e-5)
        assert not d.b.detach().any() and not d.bn.detach().any()
    with pytest.raises(ValueError, match="cell_type"):
        BiLSTM(4, 8, cell_type="rnn")


@pytest.mark.parametrize("kind", ["blstm", "bgru"])
def test_recurrent_generator_dropout_is_training_only(kind):
    """Dropout after the front end and after each recurrent layer, in
    training mode only, drawn from the explicit generator."""
    cfg = ModelConfig(generator=kind, blstm_size=16, compute_dtype="float32")
    voc, L = VocoderConfig(spec_size=5, nm_size=3), 7
    lab = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 12, L)).astype(np.float32))
    model = lambda rate: build_generator(  # noqa: E731
        dataclasses.replace(cfg, dropout_rate=rate), voc, L, generator=torch.Generator().manual_seed(4))
    plain, dropping = model(0.0), model(0.4)
    with torch.no_grad():
        eval_out = plain(lab)
        assert torch.equal(dropping(lab), eval_out)  # eval mode never drops
        assert torch.equal(plain(lab, train=True, generator=torch.Generator()), eval_out)
        a = dropping(lab, train=True, generator=torch.Generator().manual_seed(9))
        b = dropping(lab, train=True, generator=torch.Generator().manual_seed(9))
        # replayed by hand: a mask after the front end (before its tanh) and
        # one after each recurrent layer, drawn in that order
        g = torch.Generator().manual_seed(9)
        x = torch.tanh(dropout(_dense(dropping, "frontend", lab), 0.4, g))
        for i in range(cfg.blstm_layers):
            x = dropout(getattr(dropping, f"blstm_{i}")(x), 0.4, g)
        replay = _dense(dropping, "out", x).float()
    assert torch.equal(a, b) and not torch.allclose(a, eval_out)
    assert torch.equal(a, replay)
    with pytest.raises(ValueError, match="torch.Generator"):
        dropping(lab, train=True)
