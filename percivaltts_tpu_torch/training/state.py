"""Training state (counterpart of ``percivaltts_tpu/training/state.py``).

The JAX package keeps both networks, their optax states and the RNG key in
one immutable pytree that the jitted step maps to a new one. Here the state
holds the modules and their ``torch.optim.Adam`` optimizers, which the step
functions update in place, plus an explicit ``torch.Generator`` on the
device for the step's randomness (dropout masks, the gradient penalty's ε).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from percivaltts_tpu_torch.config import Configuration, TrainConfig
from percivaltts_tpu_torch.models import build_critic, build_generator


@dataclass
class GANState:
    """Generator (+ critic for the WGAN trainer) training state."""

    gen: nn.Module
    gen_opt: torch.optim.Adam
    critic: Optional[nn.Module]
    critic_opt: Optional[torch.optim.Adam]
    rng: torch.Generator
    epoch: int = 0
    step: int = 0  # generator updates taken
    # f32 EMA of the generator parameters by name (TrainConfig.ema_decay > 0)
    ema: Optional[Dict[str, torch.Tensor]] = None


def ema_update(ema: Dict[str, torch.Tensor], module: nn.Module, decay: float) -> None:
    """In place: ema ← decay·ema + (1−decay)·params, by parameter name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            ema[name].copy_(decay * ema[name] + (1.0 - decay) * p.float())


def make_adam(params, lr: float, train: TrainConfig) -> torch.optim.Adam:
    """optax ``adam(lr, b1, b2)``: eps 1e-8 outside the square root
    (``eps_root`` 0), bias correction on both moments — torch's formula."""
    return torch.optim.Adam(params, lr=lr, betas=(train.adam_b1, train.adam_b2), eps=1e-8)


def make_gan_state(
    cfg: Configuration, label_dim: int, seed: Optional[int] = None, device="cuda"
) -> GANState:
    """Build the generator (and the critic for ``trainer="wgan"``) on
    ``device`` (the card unless the caller names another, e.g. ``"cpu"``),
    their optimizers, the EMA copy and the step generator.
    Parameters are drawn on the CPU from one ``torch.Generator`` seeded with
    ``seed`` (``cfg.train.seed`` when None), generator first; the step
    generator lives on ``device`` with the same seed."""
    seed = cfg.train.seed if seed is None else seed
    device = torch.device(device)
    init = torch.Generator().manual_seed(seed)
    gen = build_generator(cfg.model, cfg.vocoder, label_dim, generator=init).to(device)
    gen_opt = make_adam(gen.parameters(), cfg.train.lr_gen, cfg.train)
    critic = critic_opt = None
    if cfg.train.trainer == "wgan":
        critic = build_critic(cfg.model, cfg.vocoder, label_dim, generator=init).to(device)
        critic_opt = make_adam(critic.parameters(), cfg.train.lr_critic, cfg.train)
    ema = None
    if cfg.train.ema_decay > 0.0:
        ema = {n: p.detach().float().clone() for n, p in gen.named_parameters()}
    return GANState(
        gen=gen,
        gen_opt=gen_opt,
        critic=critic,
        critic_opt=critic_opt,
        rng=torch.Generator(device=device).manual_seed(seed),
        ema=ema,
    )
