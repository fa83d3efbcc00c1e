"""AdamW (decoupled weight decay, arXiv:1711.05101) over nested dicts.

Counterpart of ``repro/optim/adamw.py``: the optimizer state exists only for
the trainable (LoRA) tree, and all math is f32 — the bias corrections are
computed as f32 tensors, as the reference computes them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths


class AdamWState(NamedTuple):
    step: int
    mu: Any  # first moments (tree like params)
    nu: Any  # second moments


def init_adamw(params: Any) -> AdamWState:
    flat = flatten_with_paths(params)
    zeros = {p: torch.zeros_like(x, dtype=torch.float32)
             for p, x in flat.items()}
    return AdamWState(step=0, mu=unflatten_from_paths(zeros),
                      nu=unflatten_from_paths(dict(zeros)))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 learning_rate: float, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01) -> Tuple[Any, AdamWState]:
    """Returns (new_params, new_state); new tensors, inputs untouched."""
    step = state.step + 1
    flat_p = flatten_with_paths(params)
    dev = next(iter(flat_p.values())).device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.tensor(float(step), **f32)
    b1c = 1.0 - torch.pow(torch.tensor(beta1, **f32), t)
    b2c = 1.0 - torch.pow(torch.tensor(beta2, **f32), t)
    lr = torch.tensor(learning_rate, **f32)
    flat_g = flatten_with_paths(grads)
    flat_m = flatten_with_paths(state.mu)
    flat_v = flatten_with_paths(state.nu)
    new_p, new_m, new_v = {}, {}, {}
    for path, p in flat_p.items():
        g = flat_g[path].float()
        m_new = beta1 * flat_m[path] + (1.0 - beta1) * g
        v_new = beta2 * flat_v[path] + (1.0 - beta2) * torch.square(g)
        m_hat = m_new / b1c
        v_hat = v_new / b2c
        delta = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p.float()
        new_p[path] = (p.float() - lr * delta).to(p.dtype)
        new_m[path], new_v[path] = m_new, v_new
    return unflatten_from_paths(new_p), AdamWState(
        step=step, mu=unflatten_from_paths(new_m),
        nu=unflatten_from_paths(new_v))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    flat = flatten_with_paths(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in flat.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    clipped = {p: (g.float() * scale).to(g.dtype) for p, g in flat.items()}
    return unflatten_from_paths(clipped), gnorm


@torch.no_grad()
def clip_by_lane_norm(grads: Any, max_norm: float
                      ) -> Tuple[Any, torch.Tensor]:
    """:func:`clip_by_global_norm` of every lane of a lane-stacked tree
    (leaves ``(C, …)``) by that lane's own norm over all leaves, as the
    reference's clip under ``vmap``. Returns (clipped tree, (C,) norms)."""
    flat = flatten_with_paths(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()).flatten(1), 1)
                           for g in flat.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    clipped = {p: (g.float() * scale.reshape((-1,) + (1,) * (g.ndim - 1))
                   ).to(g.dtype) for p, g in flat.items()}
    return unflatten_from_paths(clipped), gnorm
