"""Heterogeneous-rank exact aggregation (paper §6's open question).

Counterpart of ``repro/core/hetero.py``: the eager oracle of the engine's
hetero close and the ingest padding of ragged uplinks.

1. Ragged client adapters are zero-padded to r_max = max(rᵢ) (exact: padded
   rank columns multiply to zero in every product) and the ideal update
   Δ̄ = Σᵢ wᵢ·aᵢ bᵢ is formed in factored form, L = (m, k·r_max) and
   R = (k·r_max, n).
2. ONE shared Eckart–Young truncation at r_max comes from L, R through the
   (k·r_max)² Gram machinery (``engine.factored_truncated_product``);
   client i (rank rᵢ) receives the LEADING rᵢ columns/rows, which the
   balanced √s split makes the optimal rank-rᵢ truncation of Δ̄.
3. Its residual ΔWᵢ = Δ̄ − aᵢ'bᵢ' folds into its own copy of W0, so
   W0 + ΔWᵢ + aᵢ'bᵢ' = W0 + Δ̄ for every client.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import (_is_factor, map_factors,
                                          normalize_weights)

Params = Dict[str, Any]


def pad_adapters(lora: Params, r_max: int) -> Params:
    """Zero-pad every {a, b} factor of an adapter tree to rank ``r_max``
    (a's trailing columns, b's trailing rows). Exact by construction."""

    def _pad(f: Params) -> Params:
        a, b = f["a"], f["b"]
        r = a.shape[-1]
        if r == r_max:
            return {"a": a, "b": b}
        if r > r_max:
            raise ValueError(f"adapter rank {r} exceeds r_max={r_max}")
        return {"a": F.pad(a, (0, r_max - r)),
                "b": F.pad(b, (0, 0, 0, r_max - r))}

    return map_factors(_pad, lora)


def _mean_product_factors(factors: List[Params],
                          weights: Optional[Sequence[float]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factored weighted mean of products: Δ̄ = L @ R. ``weights=None``
    keeps the uniform ``a/k`` op order (the engine's uniform branch); a
    weight vector multiplies each client's L columns (its ragged branch)."""
    k = len(factors)
    if weights is None:
        lefts = [f["a"].float() / k for f in factors]
    else:
        lefts = [w_i * f["a"].float() for w_i, f in zip(weights, factors)]
    rights = [f["b"].float() for f in factors]
    return torch.cat(lefts, dim=-1), torch.cat(rights, dim=-2)


def hetero_fedex_aggregate(client_loras: List[Params],
                           client_ranks: Sequence[int],
                           weights: Optional[Sequence[float]] = None,
                           r_max: Optional[int] = None
                           ) -> Tuple[List[Params], List[Params]]:
    """Returns (per-client new adapters, per-client dense residuals).

    ``client_loras[i]`` may have rank rᵢ ≠ rⱼ (each is zero-padded to r_max
    here). ``weights`` are optional per-client weights (normalised; ``None``
    → uniform, explicit equal weights keep the weighted op order).
    ``r_max`` defaults to max(client_ranks); engine-parity callers pass the
    engine's template rank, since the decomposition depends on the padded
    width. Stacked-layer leaves batch through the Gram/eigh/svd core.
    """
    # late import: the engine imports nothing from this module
    from repro_torch.core.engine import factored_truncated_product

    k = len(client_loras)
    if len(client_ranks) != k:
        raise ValueError(f"{len(client_ranks)} ranks for {k} clients")
    if r_max is None:
        r_max = max(int(r) for r in client_ranks)
    elif r_max < max(int(r) for r in client_ranks):
        raise ValueError(f"r_max={r_max} below max client rank")
    norm = normalize_weights(weights, k)
    if weights is not None and norm is None:
        norm = [1.0 / k] * k

    def per_matrix(*factors):
        padded = [pad_adapters(f, r_max) for f in factors]
        L, R = _mean_product_factors(padded, norm)
        ap, bp = factored_truncated_product(L, R, r_max)
        ideal = L @ R
        outs = []
        for r_i in client_ranks:
            a_new = ap[..., :, :r_i]
            b_new = bp[..., :r_i, :]
            outs.append((a_new, b_new, ideal - a_new @ b_new))
        return outs

    new_loras: List[Params] = [dict() for _ in range(k)]
    residuals: List[Params] = [dict() for _ in range(k)]

    def walk(nodes, out_l, out_r):
        for key in nodes[0]:
            children = [n[key] for n in nodes]
            if _is_factor(children[0]):
                for i, (a_new, b_new, resid) in enumerate(
                        per_matrix(*children)):
                    out_l[i][key] = {"a": a_new, "b": b_new}
                    out_r[i][key] = resid
            elif isinstance(children[0], dict):
                walk(children, [o.setdefault(key, {}) for o in out_l],
                     [o.setdefault(key, {}) for o in out_r])

    walk(client_loras, new_loras, residuals)
    return new_loras, residuals
