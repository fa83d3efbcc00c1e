"""Differentially-private client uploads (paper §7's stated future work).

Counterpart of ``repro/core/privacy.py``: each client's adapter DELTA
(lora_i − lora_start) is L2-clipped to ``clip`` and Gaussian noise
N(0, σ²·clip²) is added before transmission (the Gaussian mechanism with
per-client sensitivity bounding; σ maps to (ε, δ) for a number of rounds by
the caller's accounting).

FedEx aggregation stays EXACT with respect to the noised adapters: the
server's residual absorbs whatever the clients sent, so DP costs accuracy
only through the noise itself, not through an aggregation mismatch as well.

Every draw is made in :func:`gaussian_noise_like`, from an explicit
``torch.Generator`` on the tensors' device, one leaf after another in
sorted-path order (the reference's ``jax.tree.flatten`` order).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.aggregation import _tree_map
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

Params = Dict[str, Any]


def l2_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten_with_paths(tree).values()))


def clip_delta(delta: Params, clip: float) -> Tuple[Params, torch.Tensor]:
    norm = l2_norm(delta)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return _tree_map(lambda x: (x.float() * scale).to(x.dtype), delta), norm


def gaussian_noise_like(gen: torch.Generator, tree: Params,
                        std: float) -> Params:
    """std · N(0, 1) f32 noise shaped like every leaf of ``tree``, drawn from
    ``gen`` (which must live on the leaves' device)."""
    out = {}
    for path, x in flatten_with_paths(tree).items():
        n = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        n.normal_(0.0, 1.0, generator=gen)
        out[path] = std * n
    return unflatten_from_paths(out)


def privatize_upload(gen: torch.Generator, lora_local: Params,
                     lora_global: Params, *, clip: float,
                     noise_multiplier: float) -> Params:
    """Clip + noise the adapter delta; returns the privatized local adapters.

    noise std = noise_multiplier · clip (per coordinate, Gaussian mechanism).
    """
    delta = _tree_map(lambda a, b: a.float() - b.float(), lora_local,
                      lora_global)
    delta, _ = clip_delta(delta, clip)
    noise = gaussian_noise_like(gen, delta, noise_multiplier * clip)
    return _tree_map(lambda g, d, n: (g.float() + d + n).to(g.dtype),
                     lora_global, delta, noise)
