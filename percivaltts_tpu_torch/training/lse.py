"""LSE (least-squares) trainer step and validation (counterpart of
``percivaltts_tpu/training/lse.py``): masked MSE regression with Adam.

Under a data-parallel mesh (``parallel/mesh.py``) the step takes this
rank's rows: the loss is its share over the global frame count, the
gradients are summed over the ranks in one all-reduce before the update,
and the metrics ride in that all-reduce, so they come out global."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from percivaltts_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from percivaltts_tpu_torch.training.losses import masked_mse, transition_weights
from percivaltts_tpu_torch.training.state import GANState, ema_update


def lse_step(
    state: GANState,
    batch: Dict[str, torch.Tensor],
    dim_weights=None,
    ema_decay: float = 0.0,
    boundary_weight: float = 0.0,
    boundary_radius: int = 3,
    mesh: Optional[Mesh] = None,
) -> Tuple[GANState, Dict[str, torch.Tensor]]:
    """One masked-MSE generator update, in place; metrics ``loss`` and
    ``grad_norm`` (global L2 norm of the gradients) as 0-d tensors.
    Dropout, when the model has it, draws from ``state.rng``. ``mesh``:
    ``batch`` holds this rank's rows of the global batch."""
    lab, cmp, mask = batch["lab"], batch["cmp"], batch["mask"]
    frame_w = None
    if boundary_weight > 0.0:
        frame_w = transition_weights(cmp, mask, boundary_weight, boundary_radius, mesh)
    dw = None if dim_weights is None else torch.as_tensor(dim_weights, device=cmp.device)
    rows = (0, 1, 1) if mesh is None else (mesh.rank, mesh.size, 1)
    pred = state.gen(lab, train=True, generator=state.rng, rows=rows)
    loss = masked_mse(pred, cmp, mask, dw, frame_weights=frame_w, mesh=mesh)
    state.gen_opt.zero_grad(set_to_none=True)
    loss.backward()
    (loss,) = all_reduce_grads(state.gen.parameters(), mesh, [loss])
    grads = [p.grad for p in state.gen.parameters() if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    state.gen_opt.step()
    state.step += 1
    if ema_decay > 0.0 and state.ema is not None:
        ema_update(state.ema, state.gen, ema_decay)
    return state, {"loss": loss, "grad_norm": grad_norm}


@torch.no_grad()
def lse_eval_step(state: GANState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked validation MSE (eval mode, no update)."""
    return masked_mse(state.gen(batch["lab"]), batch["cmp"], batch["mask"])


@torch.no_grad()
def lse_eval_sums(
    state: GANState, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ per-frame masked squared error, Σ mask): callers accumulate both
    over batches for a frame-weighted validation mean (under a mesh, over
    the ranks too: both are sums, so one all-reduce a validation pass
    does)."""
    pred = state.gen(batch["lab"])
    mask = batch["mask"]
    se = (pred.float() - batch["cmp"].float()).square().mean(dim=-1)
    return (se * mask).sum(), mask.sum()
