"""The bf16 recurrence at a width where the JAX package scans, on the CPU.

Past the widths its Pallas kernels fit VMEM (``pallas_vmem_ok``), the JAX
package runs ``BiLSTM._lstm_scan`` / ``_gru_scan`` (``percivaltts_tpu/models/
rnn.py``), which carry h and c in the compute dtype: in bf16 every step
rounds the carries. Every route of the port carries them in f32, as the
Pallas kernels do, and rounds only h before each product and the stored
outputs and d(gates). So in bf16 the two differ by more than the f32 layers
do (``tests/test_torch_wide_mma_stream.py`` holds those at 1e-5).

This pins the difference at H = 2048 (``blstm_size=4096``, where the port's
BPTT takes the streamed kernels' deep layout), T = 16, B = 2, nonzero
biases (drawn weights, ``random_params``): the port's bf16 layer (its CPU
twins, the kernels' arithmetic) against JAX's bf16 scan and JAX's f32 scan
on the same weights, outputs and the gradients of sum(y · dy):

- the port lies within ``OUT_TOL`` of the bf16 scan's outputs and within
  ``GRAD_TOL`` of each of its gradients' largest |value|. Both tolerances
  were set from five seeds (0–4) of both cells: the largest difference
  seen was 0.0156 on outputs (the GRU; 0.0088–0.0146 on the other seeds,
  one or two bf16 ulps near |y| = 1) and 0.024 of a gradient's largest
  |value| (the LSTM; 0.014–0.021 on the others), each then given about
  twice its room;
- the port is no further from the f32 scan than the bf16 scan is: its f32
  carries only take error away (outputs and every gradient, each by its
  largest |difference| from the f32 scan's).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wide_mma_stream import random_params

from percivaltts_tpu.models.rnn import BiLSTM as JaxBiLSTM
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.models.rnn import BiLSTM

H, T, B, D = 2048, 16, 2, 48
OUT_TOL = 0.03  # |port − bf16 scan| of the outputs (largest seen: 0.0156)
GRAD_TOL = 0.05  # of each gradient's largest |value| (largest seen: 0.024)


def _run(cell: str, seed: int):
    """Outputs and gradients (x, then every parameter in the port's order)
    of sum(y · dy) for the port's bf16 layer, JAX's bf16 scan and JAX's f32
    scan, on the same f32 weights: {"port", "bf16", "f32"} → (y, grads)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    dy = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    # weights drawn with no initialiser run (test_torch_wide_mma_stream.random_params:
    # the orthogonal init's QR at this width is most of a test's time), biases nonzero
    params = random_params(JaxBiLSTM(H, compute_dtype="float32", cell_type=cell, use_pallas=False),
                           jnp.asarray(x), rng)
    tm = BiLSTM(D, H, compute_dtype="bfloat16", cell_type=cell)
    weights.load_flax_params(tm, jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    runs = {"port": (y.detach().float().numpy(),
                     [xt.grad.numpy()] + [p.grad.numpy() for p in tm.parameters()])}
    for key, dt in (("bf16", "bfloat16"), ("f32", "float32")):
        jm = JaxBiLSTM(H, compute_dtype=dt, cell_type=cell, use_pallas=False)

        def loss(p, xx, jm=jm):
            yj = jm.apply(p, xx)
            return jnp.sum(yj.astype(jnp.float32) * dy), yj

        (_, yj), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        by_param = {id(p): v for p, v in weights._converted(tm, jax.tree.map(np.asarray, gp))}
        runs[key] = (np.asarray(yj.astype(jnp.float32)),
                     [np.asarray(gx.astype(jnp.float32))]
                     + [np.asarray(by_param[id(p)], np.float32) for p in tm.parameters()])
    return runs


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_port_bf16_layer_lies_within_the_bf16_scan_and_nearer_the_f32_scan(cell):
    """The port's bf16 layer against JAX's bf16 and f32 scans at H = 2048
    (the module docstring gives the tolerances and how they were set)."""
    runs = _run(cell, seed=0)
    (y, grads), (yb, gb), (yf, gf) = runs["port"], runs["bf16"], runs["f32"]
    assert y.shape == yb.shape == (B, T, 2 * H)
    assert len(grads) == len(gb) == len(gf) == (7 if cell == "lstm" else 9)
    assert np.abs(y - yb).max() <= OUT_TOL
    for g, w in zip(grads, gb):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()
    # the f32 carries take error away: no further from the f32 scan than the bf16 scan
    assert np.abs(y - yf).max() <= np.abs(yb - yf).max()
    for g, w, f in zip(grads, gb, gf):
        assert np.abs(g - f).max() <= np.abs(w - f).max()
