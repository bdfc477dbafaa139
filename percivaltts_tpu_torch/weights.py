"""Flax parameter tree ↔ the port's modules.

The JAX package's generator parameters, as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``, made by the caller on a host that has
jax), are flattened to ``/``-joined flax paths such as ``trunk_0/kernel`` or
``f0_blstm/fwd/hi`` and copied into the port's modules:

* Dense kernel (in, out)      → ``nn.Linear.weight`` (out, in)
* Conv kernel (k, in, out)    → ``nn.Conv1d.weight`` (out, in, k)
* Conv kernel (kh, kw, in, out) → ``nn.Conv2d.weight`` (out, in, kh, kw)
* LSTM per-gate ``i{c}`` / ``h{c}`` / ``b{c}`` → ``wi`` / ``wh`` / ``b``,
  concatenated in gate order i, f, g, o
* GRU per-gate ``i{c}`` / ``h{c}`` / ``b{c}`` → ``wi`` / ``wh`` / ``b``,
  concatenated in gate order r, z, n, and ``bhn`` → ``bn``
* LayerNorm ``scale`` / ``bias`` → ``nn.LayerNorm.weight`` / ``bias`` (the
  critic's ``spec_ln{i}``, the generators' ``reg_{i}_ln`` / ``reg_fe_ln``)

A missing or an unused key raises. The same flat mapping is what
``save_npz`` writes and ``load_npz`` reads — the weights file of the port's
``cli synth``. ``load_optax_adam_state`` carries optax's Adam moments,
which have the parameters' tree, into a ``torch.optim.Adam`` the same way.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from percivaltts_tpu_torch.models.rnn import GRUDirParams, LSTMDirParams

_GATES = {LSTMDirParams: "ifgo", GRUDirParams: "rzn"}

Entry = Tuple[List[str], torch.nn.Parameter, Callable[[List[np.ndarray]], np.ndarray]]


def flatten(params: Mapping) -> Dict[str, np.ndarray]:
    """Nested flax tree (optionally under a single ``params`` key) → flat
    ``{"a/b/c": array}``. An already-flat mapping passes through."""
    if set(params) == {"params"} and isinstance(params["params"], Mapping):
        params = params["params"]
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, path)
            else:
                flat[path] = np.asarray(v)

    walk(params, "")
    return flat


def save_npz(path: str, params: Mapping) -> None:
    """Write a flax tree (nested or flat) as a flat ``.npz`` keyed by path."""
    np.savez(path, **flatten(params))


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _entries(model: nn.Module) -> Iterator[Entry]:
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, nn.Linear):
            yield [f"{path}/kernel"], mod.weight, lambda a: a[0].T
            yield [f"{path}/bias"], mod.bias, lambda a: a[0]
        elif isinstance(mod, nn.Conv1d):
            yield [f"{path}/kernel"], mod.weight, lambda a: a[0].transpose(2, 1, 0)
            yield [f"{path}/bias"], mod.bias, lambda a: a[0]
        elif isinstance(mod, nn.Conv2d):
            yield [f"{path}/kernel"], mod.weight, lambda a: a[0].transpose(3, 2, 0, 1)
            yield [f"{path}/bias"], mod.bias, lambda a: a[0]
        elif isinstance(mod, nn.LayerNorm):
            yield [f"{path}/scale"], mod.weight, lambda a: a[0]
            yield [f"{path}/bias"], mod.bias, lambda a: a[0]
        elif isinstance(mod, (LSTMDirParams, GRUDirParams)):
            gates = _GATES[type(mod)]
            cat = lambda a: np.concatenate(a, axis=-1)  # noqa: E731
            yield [f"{path}/i{c}" for c in gates], mod.wi, cat
            yield [f"{path}/h{c}" for c in gates], mod.wh, cat
            yield [f"{path}/b{c}" for c in gates], mod.b, cat
            if isinstance(mod, GRUDirParams):
                yield [f"{path}/bhn"], mod.bn, lambda a: a[0]


def _converted(model: nn.Module, params: Mapping) -> List[Tuple[nn.Parameter, np.ndarray]]:
    """(parameter, value in the port's layout) for every parameter of
    ``model``, from a flax tree. Raises ``KeyError`` on a key the model
    needs that the tree lacks, ``ValueError`` on a key the model does not
    use or a shape that does not match."""
    flat = flatten(params)
    entries = list(_entries(model))
    covered = {id(p) for _, p, _ in entries}
    stray = [n for n, p in model.named_parameters() if id(p) not in covered]
    if stray:
        raise TypeError(f"no flax mapping for parameters {stray}")
    missing = sorted(k for keys, _, _ in entries for k in keys if k not in flat)
    if missing:
        raise KeyError(f"flax tree lacks {missing}")
    used = {k for keys, _, _ in entries for k in keys}
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"flax tree has keys the model does not use: {unused}")
    out = []
    for keys, param, convert in entries:
        value = np.array(convert([flat[k] for k in keys]), dtype=np.float32, order="C")
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"{keys[0]}: converted shape {value.shape} != {tuple(param.shape)}"
            )
        out.append((param, value))
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax parameter tree (nested, or flat as from ``load_npz``) into
    ``model`` in place. Raises as :func:`_converted`."""
    with torch.no_grad():
        for param, value in _converted(model, params):
            param.copy_(torch.from_numpy(value))
    return model


def load_optax_adam_state(
    optimizer: torch.optim.Adam, model: nn.Module, adam_state: Any
) -> torch.optim.Adam:
    """Carry optax's ``ScaleByAdamState(count, mu, nu)`` (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, opt_state[0])``; a mapping with those keys
    works too) into ``optimizer``'s per-parameter ``step`` / ``exp_avg`` /
    ``exp_avg_sq`` for ``model``'s parameters. optax's Adam with
    ``eps_root=0`` and ``torch.optim.Adam`` apply the same update, so a step
    taken from the loaded state continues the JAX run like for like."""
    get = adam_state.get if isinstance(adam_state, Mapping) else (
        lambda k: getattr(adam_state, k))
    count = float(np.asarray(get("count")))
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    mus, nus = _converted(model, get("mu")), _converted(model, get("nu"))
    for (param, mu), (_, nu) in zip(mus, nus):
        if id(param) not in owned:
            raise ValueError("the optimizer does not hold every parameter of the model")
        optimizer.state[param] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.from_numpy(mu).to(param.device, param.dtype),
            "exp_avg_sq": torch.from_numpy(nu).to(param.device, param.dtype),
        }
    return optimizer
