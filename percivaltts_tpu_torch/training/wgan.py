"""Fused WGAN-GP training step (counterpart of
``percivaltts_tpu/training/wgan.py``).

Per generator update, ``n_critic`` critic updates each minimizing

    D(fake) − D(real) + λ·gp_every · (‖∇_x̂ D(x̂)‖₂ − 1)²,   x̂ = ε·real + (1−ε)·fake

(the penalty masked to valid frames and taken on the iterations
``i % gp_every == 0``), then one generator update minimizing
``−D(G(lab)) + lse_weight·LSE`` against the UPDATED critic, then the EMA.
The fakes for all critic updates come from one no-grad generator pass over
the ``n_critic·B`` stacked label rows, in training mode. Each recurrent
layer of the generator (BiLSTM or BiGRU) runs its forward kernel in that
pass and in the generator update, and its BPTT kernel in the update's
backward.

Under a data-parallel mesh (``parallel/mesh.py``) every batch holds this
rank's rows. The means over the batch become local means divided by the
rank count, the LSE term takes the global frame count, ε and the dropout
masks are drawn at the global shape and cut to the rank's rows, and each
of the ``n_critic + 1`` updates sums its gradients over the ranks in one
all-reduce before the optimizer steps; the metrics ride in the generator's
all-reduce. Each rank thus takes the step world size 1 takes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from percivaltts_tpu_torch.config import TrainConfig
from percivaltts_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from percivaltts_tpu_torch.training.losses import masked_mse, transition_weights
from percivaltts_tpu_torch.training.state import GANState, ema_update

Batch = Dict[str, torch.Tensor]


def make_wgan_step(
    cfg: TrainConfig, dim_weights=None, mesh: Optional[Mesh] = None
) -> Callable[..., Tuple[GANState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, critic_batches, gen_batch, eps=None)``.

    ``critic_batches`` carries a leading ``n_critic`` axis (one batch per
    critic update); ``gen_batch`` is the generator update's batch. ``eps``
    (``(n_critic, B, 1, 1)``, uniform in [0, 1)) is the gradient penalty's
    interpolation weights; drawn from ``state.rng`` when None. The step
    updates ``state`` in place and returns it with 0-d metric tensors
    ``loss``, ``gen_adv``, ``lse``, ``w_dist``, ``gp`` (no host sync).
    ``dim_weights``: per-dimension LSE weights (``stream_weight_vector``).
    ``mesh``: the batches hold this rank's rows; ``eps`` is then the global
    ``(n_critic, B_global, 1, 1)`` draw, and the metrics are global."""
    n_critic = cfg.n_critic
    gp_lambda = cfg.gp_lambda
    gp_every = max(1, cfg.gp_every)
    lse_weight = cfg.lse_weight
    rank, n_ranks = (0, 1) if mesh is None else (mesh.rank, mesh.size)

    def batch_mean(x):
        """This rank's share of the mean over the global batch."""
        return x.mean() / n_ranks

    def scores(critic, real, fake, lab, mask):
        if cfg.critic_fused_pass:  # one 2B-batch pass for both scores
            B = real.shape[0]
            d = critic(torch.cat([real, fake]), torch.cat([lab, lab]), torch.cat([mask, mask]))
            return d[:B], d[B:]
        return critic(real, lab, mask), critic(fake, lab, mask)

    def critic_loss(critic, batch: Batch, fake, eps, apply_gp: bool):
        lab, real, mask = batch["lab"], batch["cmp"], batch["mask"]
        d_real, d_fake = scores(critic, real, fake, lab, mask)
        w_dist = batch_mean(d_real) - batch_mean(d_fake)
        if not apply_gp:
            return -w_dist, w_dist, torch.zeros_like(w_dist)
        interp = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
        (g,) = torch.autograd.grad(critic(interp, lab, mask).sum(), interp, create_graph=True)
        g = g * mask[..., None]
        gnorm = torch.sqrt(g.square().sum(dim=(1, 2)) + 1e-12)
        gp = batch_mean((gnorm - 1.0).square())
        return -w_dist + (gp_lambda * gp_every) * gp, w_dist, gp

    def step(state: GANState, critic_batches: Batch, gen_batch: Batch,
             eps: Optional[torch.Tensor] = None):
        gen, critic = state.gen, state.critic
        lab_all = critic_batches["lab"]
        nc, B = lab_all.shape[:2]
        if nc != n_critic:
            raise ValueError(f"critic_batches carry {nc} batches, n_critic is {n_critic}")
        if eps is None:
            eps = torch.rand((nc, B * n_ranks, 1, 1), generator=state.rng,
                             device=lab_all.device)
        if mesh is not None:
            eps = eps[:, mesh.rows(eps.shape[1])]

        # generator frozen during the critic loop: one batched no-grad pass
        with torch.no_grad():
            fakes = gen(lab_all.reshape((nc * B,) + lab_all.shape[2:]), train=True,
                        generator=state.rng, rows=(rank, n_ranks, nc))
        fakes = fakes.reshape((nc, B) + fakes.shape[1:])

        w_sum = gp_sum = torch.zeros((), device=lab_all.device)
        for i in range(nc):
            batch = {k: v[i] for k, v in critic_batches.items()}
            loss, w, gp = critic_loss(critic, batch, fakes[i], eps[i], i % gp_every == 0)
            state.critic_opt.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads(critic.parameters(), mesh)
            state.critic_opt.step()
            w_sum = w_sum + w.detach()
            gp_sum = gp_sum + gp.detach()

        # generator update against the updated critic, whose parameters take
        # no gradient here (and are unfrozen even when the update raises)
        lab, real, mask = gen_batch["lab"], gen_batch["cmp"], gen_batch["mask"]
        critic.requires_grad_(False)
        try:
            fake = gen(lab, train=True, generator=state.rng, rows=(rank, n_ranks, 1))
            adv = -batch_mean(critic(fake, lab, mask))
            frame_w = None
            if cfg.boundary_weight > 0.0:
                frame_w = transition_weights(real, mask, cfg.boundary_weight,
                                             cfg.boundary_radius, mesh)
            dw = None if dim_weights is None else torch.as_tensor(dim_weights, device=real.device)
            lse = masked_mse(fake, real, mask, dw, frame_weights=frame_w, mesh=mesh)
            gen_loss = adv + lse_weight * lse
            state.gen_opt.zero_grad(set_to_none=True)
            gen_loss.backward()
        finally:
            critic.requires_grad_(True)
        # the metrics' shares ride in the generator's all-reduce
        gen_loss, adv, lse, w_sum, gp_sum = all_reduce_grads(
            gen.parameters(), mesh, [gen_loss, adv, lse, w_sum, gp_sum])
        state.gen_opt.step()
        state.step += 1
        if cfg.ema_decay > 0.0 and state.ema is not None:
            ema_update(state.ema, gen, cfg.ema_decay)

        metrics = {
            "loss": gen_loss,
            "gen_adv": adv,
            "lse": lse,
            "w_dist": w_sum / nc,
            # averaged over the iterations that computed it
            "gp": gp_sum / len(range(0, nc, gp_every)),
        }
        return state, metrics

    return step
