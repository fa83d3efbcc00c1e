"""Deviation analysis (paper §6, Figures 2–9): the scaled Frobenius norm of
the gap between FedAvg-of-factors (FedIT) updates and ideal LoRA updates.

Counterpart of ``repro/core/divergence.py``:

deviation(path) = ‖ mean_i(aᵢbᵢ) − ā b̄ ‖_F / sqrt(m·n)   (scaled by size)
relative(path) = ‖ mean_i(aᵢbᵢ) − ā b̄ ‖_F / ‖ mean_i(aᵢbᵢ) ‖_F

The deviation is always taken against the UNIFORM FedIT mean, also for a
weighted round, as the reference's is. Products are f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.aggregation import fedit_aggregate, map_factors
from repro_torch.util.tree import flatten_with_paths

Params = Dict[str, Any]


def deviation_tree(client_loras: List[Params]) -> Params:
    """Per-factor dict of {"scaled", "relative", "fro"} tensors (one value
    per stacked layer for stacked leaves)."""
    k = len(client_loras)
    global_lora = fedit_aggregate(client_loras)

    def fn(g, *factors):
        mean_prod = sum(torch.matmul(f["a"].float(), f["b"].float())
                        for f in factors) / k
        prod_mean = torch.matmul(g["a"].float(), g["b"].float())
        dev = mean_prod - prod_mean
        fro = torch.sqrt(torch.sum(torch.square(dev), dim=(-2, -1)))
        size = dev.shape[-2] * dev.shape[-1]
        ideal_fro = torch.sqrt(torch.sum(torch.square(mean_prod),
                                         dim=(-2, -1)))
        return {"fro": fro, "scaled": fro / math.sqrt(size),
                "relative": fro / torch.clamp(ideal_fro, min=1e-12)}

    return map_factors(fn, global_lora, *client_loras)


def flatten_deviations(dev_tree: Params, metric: str = "scaled"
                       ) -> Dict[str, np.ndarray]:
    """path → value on the host (stacked-layer leaves stay arrays over the
    layer axis)."""
    out = {}
    for path, val in flatten_with_paths(dev_tree).items():
        if path.endswith("/" + metric):
            out[path[: -len("/" + metric)]] = val.detach().cpu().numpy()
    return out


def mean_deviation(client_loras: List[Params],
                   metric: str = "scaled") -> float:
    dev = flatten_deviations(deviation_tree(client_loras), metric)
    vals = np.concatenate([np.atleast_1d(v).ravel() for v in dev.values()])
    return float(vals.mean())
