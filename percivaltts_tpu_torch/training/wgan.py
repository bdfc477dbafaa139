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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from percivaltts_tpu_torch.config import TrainConfig
from percivaltts_tpu_torch.training.losses import masked_mse, transition_weights
from percivaltts_tpu_torch.training.state import GANState, ema_update

Batch = Dict[str, torch.Tensor]


def make_wgan_step(
    cfg: TrainConfig, dim_weights=None
) -> Callable[..., Tuple[GANState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, critic_batches, gen_batch, eps=None)``.

    ``critic_batches`` carries a leading ``n_critic`` axis (one batch per
    critic update); ``gen_batch`` is the generator update's batch. ``eps``
    (``(n_critic, B, 1, 1)``, uniform in [0, 1)) is the gradient penalty's
    interpolation weights; drawn from ``state.rng`` when None. The step
    updates ``state`` in place and returns it with 0-d metric tensors
    ``loss``, ``gen_adv``, ``lse``, ``w_dist``, ``gp`` (no host sync).
    ``dim_weights``: per-dimension LSE weights (``stream_weight_vector``)."""
    n_critic = cfg.n_critic
    gp_lambda = cfg.gp_lambda
    gp_every = max(1, cfg.gp_every)
    lse_weight = cfg.lse_weight

    def scores(critic, real, fake, lab, mask):
        if cfg.critic_fused_pass:  # one 2B-batch pass for both scores
            B = real.shape[0]
            d = critic(torch.cat([real, fake]), torch.cat([lab, lab]), torch.cat([mask, mask]))
            return d[:B], d[B:]
        return critic(real, lab, mask), critic(fake, lab, mask)

    def critic_loss(critic, batch: Batch, fake, eps, apply_gp: bool):
        lab, real, mask = batch["lab"], batch["cmp"], batch["mask"]
        d_real, d_fake = scores(critic, real, fake, lab, mask)
        w_dist = d_real.mean() - d_fake.mean()
        if not apply_gp:
            return -w_dist, w_dist, torch.zeros_like(w_dist)
        interp = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
        (g,) = torch.autograd.grad(critic(interp, lab, mask).sum(), interp, create_graph=True)
        g = g * mask[..., None]
        gnorm = torch.sqrt(g.square().sum(dim=(1, 2)) + 1e-12)
        gp = (gnorm - 1.0).square().mean()
        return -w_dist + (gp_lambda * gp_every) * gp, w_dist, gp

    def step(state: GANState, critic_batches: Batch, gen_batch: Batch,
             eps: Optional[torch.Tensor] = None):
        gen, critic = state.gen, state.critic
        lab_all = critic_batches["lab"]
        nc, B = lab_all.shape[:2]
        if nc != n_critic:
            raise ValueError(f"critic_batches carry {nc} batches, n_critic is {n_critic}")
        if eps is None:
            eps = torch.rand((nc, B, 1, 1), generator=state.rng, device=lab_all.device)

        # generator frozen during the critic loop: one batched no-grad pass
        with torch.no_grad():
            fakes = gen(lab_all.reshape((nc * B,) + lab_all.shape[2:]), train=True,
                        generator=state.rng)
        fakes = fakes.reshape((nc, B) + fakes.shape[1:])

        w_sum = gp_sum = torch.zeros((), device=lab_all.device)
        for i in range(nc):
            batch = {k: v[i] for k, v in critic_batches.items()}
            loss, w, gp = critic_loss(critic, batch, fakes[i], eps[i], i % gp_every == 0)
            state.critic_opt.zero_grad(set_to_none=True)
            loss.backward()
            state.critic_opt.step()
            w_sum = w_sum + w.detach()
            gp_sum = gp_sum + gp.detach()

        # generator update against the updated critic, whose parameters take
        # no gradient here (and are unfrozen even when the update raises)
        lab, real, mask = gen_batch["lab"], gen_batch["cmp"], gen_batch["mask"]
        critic.requires_grad_(False)
        try:
            fake = gen(lab, train=True, generator=state.rng)
            adv = -critic(fake, lab, mask).mean()
            frame_w = None
            if cfg.boundary_weight > 0.0:
                frame_w = transition_weights(real, mask, cfg.boundary_weight, cfg.boundary_radius)
            dw = None if dim_weights is None else torch.as_tensor(dim_weights, device=real.device)
            lse = masked_mse(fake, real, mask, dw, frame_weights=frame_w)
            gen_loss = adv + lse_weight * lse
            state.gen_opt.zero_grad(set_to_none=True)
            gen_loss.backward()
        finally:
            critic.requires_grad_(True)
        state.gen_opt.step()
        state.step += 1
        if cfg.ema_decay > 0.0 and state.ema is not None:
            ema_update(state.ema, gen, cfg.ema_decay)

        metrics = {
            "loss": gen_loss.detach(),
            "gen_adv": adv.detach(),
            "lse": lse.detach(),
            "w_dist": w_sum / nc,
            # averaged over the iterations that computed it
            "gp": gp_sum / len(range(0, nc, gp_every)),
        }
        return state, metrics

    return step
