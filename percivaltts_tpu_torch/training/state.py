"""Training state (counterpart of ``percivaltts_tpu/training/state.py``).

The JAX package keeps both networks, their optax states and the RNG key in
one immutable pytree that the jitted step maps to a new one. Here the state
holds the modules and their ``torch.optim.Adam`` optimizers, which the step
functions update in place, plus an explicit ``torch.Generator`` on the
device for the step's randomness (dropout masks, the gradient penalty's ε).
``state_dict`` / ``load_state_dict`` carry all of it, which is what a
checkpoint holds (``training/checkpoints.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from percivaltts_tpu_torch.config import Configuration, TrainConfig
from percivaltts_tpu_torch.models import build_critic, build_generator
from percivaltts_tpu_torch.parallel.mesh import replicate_state


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

    def state_dict(self) -> Dict[str, Any]:
        """Both modules, both Adam states, the step generator's state, the
        counters and the EMA: every entry a tensor, a number, a plain
        container or None (``torch.load(..., weights_only=True)`` reads it)."""
        return {
            "gen": self.gen.state_dict(),
            "gen_opt": self.gen_opt.state_dict(),
            "critic": None if self.critic is None else self.critic.state_dict(),
            "critic_opt": None if self.critic_opt is None else self.critic_opt.state_dict(),
            "rng": self.rng.get_state(),
            "epoch": int(self.epoch),
            "step": int(self.step),
            "ema": None if self.ema is None else dict(self.ema),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """In place, from :meth:`state_dict` (tensors on any device). The
        EMA is taken as the dict holds it: set or None."""
        if (sd["critic"] is None) != (self.critic is None):
            raise ValueError("the state dict and this state disagree on having a critic")
        self.gen.load_state_dict(sd["gen"])
        self.gen_opt.load_state_dict(sd["gen_opt"])
        _steps_on_host(self.gen_opt)
        if self.critic is not None:
            self.critic.load_state_dict(sd["critic"])
            self.critic_opt.load_state_dict(sd["critic_opt"])
            _steps_on_host(self.critic_opt)
        self.rng.set_state(sd["rng"].cpu())
        self.epoch, self.step = int(sd["epoch"]), int(sd["step"])
        device = next(self.gen.parameters()).device
        self.ema = None if sd["ema"] is None else {
            n: t.to(device=device, dtype=torch.float32, copy=True) for n, t in sd["ema"].items()
        }


def _steps_on_host(opt: torch.optim.Adam) -> None:
    """Adam keeps its step counters on the host unless ``capturable`` or
    ``fused``; a state dict loaded onto the card would put them there, and
    every step would then read each one back."""
    for group in opt.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].cpu()


def eval_params(state: GANState) -> Dict[str, torch.Tensor]:
    """Generator parameters by name that every quality-facing consumer
    should use: the EMA copy when the run carries one, else the live
    parameters. Used by serving from a checkpoint (``cli synth``)."""
    if state.ema is not None:
        return state.ema
    return dict(state.gen.named_parameters())


def eval_generator(state: GANState) -> nn.Module:
    """A copy of ``state.gen`` in eval mode, without gradients, holding
    :func:`eval_params`; the live generator is left as it is."""
    gen = copy.deepcopy(state.gen).eval()
    params = eval_params(state)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            p.grad = None
            p.copy_(params[name])
    return gen.requires_grad_(False)


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
    cfg: Configuration, label_dim: int, seed: Optional[int] = None, device="cuda", mesh=None
) -> GANState:
    """Build the generator (and the critic for ``trainer="wgan"``) on
    ``device`` (the card unless the caller names another, e.g. ``"cpu"``),
    their optimizers, the EMA copy and the step generator.
    Parameters are drawn on the CPU from one ``torch.Generator`` seeded with
    ``seed`` (``cfg.train.seed`` when None), generator first; the step
    generator lives on ``device`` with the same seed. ``mesh``
    (``parallel.make_mesh``): build on the rank's device, then take rank
    0's state on every rank (``parallel.replicate_state``)."""
    seed = cfg.train.seed if seed is None else seed
    device = torch.device(device if mesh is None else mesh.device)
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
    state = GANState(
        gen=gen,
        gen_opt=gen_opt,
        critic=critic,
        critic_opt=critic_opt,
        rng=torch.Generator(device=device).manual_seed(seed),
        ema=ema,
    )
    if mesh is not None:
        replicate_state(state, mesh)
    return state
