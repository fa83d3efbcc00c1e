"""Federated aggregation operators — the paper's contribution (§4).

Counterpart of the operators of ``repro/core/aggregation.py`` that the
uniform round close composes. They act on *lists of client adapter trees*
(every factor leaf ``a: (..., d_in, r)`` / ``b: (..., r, d_out)``, leading
stacked-layer axes batched by ``torch.matmul``):

* ``fedit``  — FedAvg of the factors (inexact; Eq. 3–4).
* ``fedex``  — factor averages + residual ΔW_res = Σwᵢaᵢbᵢ − ā b̄
  (Eq. 11–12); folding scale·ΔW_res into W0 makes aggregation exact.
* ``fedex_svd`` — FedEx with the residual's Eckart–Young rank-r'
  truncation (Eq. 15–16), the dense oracle of the engine's svd close.
* ``ffa``    — FFA-LoRA: a frozen at init, b averaged (exact by
  construction).
* the assignment strategies of Table 5 (``assign_after_aggregation``):
  ``keep_local`` (per-client residuals Σwⱼaⱼbⱼ − aᵢbᵢ) and ``reinit``
  (fresh adapters, the full ideal update folded).

Optional per-client ``weights`` are normalised to sum 1; ``None`` or an
all-equal vector takes the ``sum/k`` path, which the engine's uniform close
reproduces op for op.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, Any]

Weights = Optional[Sequence[float]]


def normalize_weights(weights: Weights, k: int) -> Optional[List[float]]:
    """Validate + normalize client weights to sum 1; ``None`` for the uniform
    case (including any all-equal vector)."""
    if weights is None:
        return None
    w = [float(x) for x in weights]
    if len(w) != k:
        raise ValueError(f"got {len(w)} weights for {k} clients")
    if any(x < 0 for x in w):
        raise ValueError(f"negative client weight in {w}")
    total = sum(w)
    if total <= 0:
        raise ValueError(f"client weights sum to {total}; need > 0")
    w = [x / total for x in w]
    if all(x == w[0] for x in w):
        return None  # uniform → legacy path
    return w


def _is_factor(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) >= {"a", "b"}


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def tree_mean(trees: List[Params], weights: Weights = None) -> Params:
    k = len(trees)
    w = normalize_weights(weights, k)
    if w is None:
        return _tree_map(lambda *xs: sum(x.float() for x in xs) / k, *trees)
    return _tree_map(lambda *xs: sum(wi * x.float() for wi, x in zip(w, xs)),
                     *trees)


def map_factors(fn, *trees: Params) -> Params:
    """Apply ``fn(*factor_dicts) → value`` at every {a, b} node."""

    def walk(*nodes):
        if _is_factor(nodes[0]):
            return fn(*nodes)
        if isinstance(nodes[0], dict):
            return {k: walk(*[n[k] for n in nodes]) for k in nodes[0]}
        return nodes[0]

    return walk(*trees)


def fedit_aggregate(client_loras: List[Params],
                    weights: Weights = None) -> Params:
    """FedAvg of A and B independently (Eq. 3). Inexact (Eq. 4)."""
    return tree_mean(client_loras, weights)


def product_mean(client_loras: List[Params], weights: Weights = None) -> Params:
    """Ideal update per factor: Σwᵢ aᵢ @ bᵢ (uniform default)."""
    k = len(client_loras)
    w = normalize_weights(weights, k)

    def fn(*factors):
        prods = (torch.matmul(f["a"].float(), f["b"].float()) for f in factors)
        if w is None:
            return sum(prods) / k
        return sum(wi * p for wi, p in zip(w, prods))

    return map_factors(fn, *client_loras)


def fedex_residual(client_loras: List[Params],
                   global_lora: Optional[Params] = None,
                   weights: Weights = None) -> Params:
    """ΔW_res = Σwᵢ aᵢbᵢ − ā b̄ per factor (Eq. 12; uniform wᵢ=1/k), f32."""
    if global_lora is None:
        global_lora = fedit_aggregate(client_loras, weights)
    k = len(client_loras)
    w = normalize_weights(weights, k)

    def fn(g, *factors):
        prods = (torch.matmul(f["a"].float(), f["b"].float()) for f in factors)
        if w is None:
            mean_prod = sum(prods) / k
        else:
            mean_prod = sum(wi * p for wi, p in zip(w, prods))
        prod_mean = torch.matmul(g["a"].float(), g["b"].float())
        return mean_prod - prod_mean

    return map_factors(fn, global_lora, *client_loras)


def fedex_aggregate(client_loras: List[Params], weights: Weights = None
                    ) -> Tuple[Params, Params]:
    """Returns (global_lora, residual_tree). Eq. 11–12."""
    global_lora = fedit_aggregate(client_loras, weights)
    residual = fedex_residual(client_loras, global_lora, weights)
    return global_lora, residual


def _factor_rank(tree: Params) -> int:
    """Rank r of the first {a, b} factor node found in an adapter tree."""
    found: List[int] = []

    def fn(factor):
        if not found:
            found.append(int(factor["a"].shape[-1]))
        return None

    map_factors(fn, tree)
    if not found:
        raise ValueError("no adapter factors found — empty lora tree?")
    return found[0]


def fedex_svd_aggregate(client_loras: List[Params], svd_rank: int,
                        weights: Weights = None) -> Tuple[Params, Params]:
    """FedEx with rank-r' truncated residual (Eq. 15–16, Eckart–Young optimal).

    ``svd_rank`` must satisfy 1 ≤ r' ≤ k·r (the residual's rank bound —
    ΔW_res = Σwᵢaᵢ(bᵢ − b̄) has at most k·r nonzero singular values).
    The config-level meaning of ``FedConfig.svd_rank = 0`` ("exact") is
    resolved by the caller to the plain fedex close, never down here.
    Stacked-layer leaves go through one batched ``torch.linalg.svd``.
    """
    k = len(client_loras)
    r = _factor_rank(client_loras[0])
    if svd_rank < 1:
        raise ValueError(
            f"fedex_svd_aggregate needs svd_rank ≥ 1, got {svd_rank} "
            "(svd_rank=0 means 'exact' at the config level — callers "
            "resolve that to fedex_aggregate, which never truncates)")
    if svd_rank > k * r:
        raise ValueError(
            f"svd_rank={svd_rank} exceeds the residual rank bound "
            f"k·r = {k}·{r} = {k * r}; ranks past it only pad the transmit")
    global_lora, residual = fedex_aggregate(client_loras, weights)

    def trunc(res):
        u, s, vt = torch.linalg.svd(res, full_matrices=False)
        return ((u[..., :, :svd_rank] * s[..., None, :svd_rank])
                @ vt[..., :svd_rank, :])

    return global_lora, _tree_map(trunc, residual)


def ffa_aggregate(client_loras: List[Params],
                  weights: Weights = None) -> Params:
    """FFA-LoRA: a is frozen (identical across clients) → average b only.
    Averaging a too keeps the code uniform; aggregation is exact (for any
    weights) because Σwᵢ a bᵢ = a Σwᵢbᵢ."""
    return tree_mean(client_loras, weights)


def assign_after_aggregation(strategy: str, client_loras: List[Params],
                             gen: Optional[torch.Generator] = None,
                             weights: Weights = None
                             ) -> Tuple[List[Params], Params]:
    """Returns (per-client new adapters, residual to fold into W0).

    Every strategy is EXACT: the residual is chosen so that for each client
    ``W0 + scale·(residual + aᵢ_new bᵢ_new) = W0 + scale·Σwⱼ aⱼbⱼ``.
    ``keep_local`` returns client 0's residual (the trainer folds each
    client's own); ``reinit`` draws from ``gen`` (a fresh generator seeded
    0 on the adapters' device when omitted).
    """
    k = len(client_loras)
    if strategy == "average":  # FedEx-LoRA
        global_lora, residual = fedex_aggregate(client_loras, weights)
        return [global_lora] * k, residual
    if strategy == "keep_local":
        return (list(client_loras),
                per_client_residuals(client_loras, weights)[0])
    if strategy == "reinit":
        ideal = product_mean(client_loras, weights)
        if gen is None:
            device = next(iter(_leaves(client_loras[0]))).device
            gen = torch.Generator(device=device).manual_seed(0)
        new = reinit_adapters(client_loras[0], gen)
        # b = 0 → product 0 → the FULL ideal update goes into the residual
        return [new] * k, ideal
    raise ValueError(f"unknown assignment strategy {strategy!r}")


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def reinit_adapters(template: Params, gen: torch.Generator) -> Params:
    """Fresh adapters for the reinit strategy: a ~ N(0, 0.02), b = 0.

    The factors are drawn from ``gen`` one leaf after another in the
    factor traversal's (insertion) order — the reference's per-leaf counter
    order. Shared by :func:`assign_after_aggregation` and the engine's
    reinit close, so both draw identical adapters from generators in the
    same state. ``gen`` must live on the template's device.
    """

    def reinit(factor):
        a = torch.empty(factor["a"].shape, dtype=torch.float32,
                        device=factor["a"].device)
        a.normal_(0.0, 0.02, generator=gen)
        return {"a": a, "b": torch.zeros(factor["b"].shape,
                                         dtype=torch.float32,
                                         device=factor["b"].device)}

    return map_factors(reinit, template)


def per_client_residuals(client_loras: List[Params],
                         weights: Weights = None) -> List[Params]:
    """keep_local residuals, eager oracle: residual_i = Σwⱼaⱼbⱼ − aᵢ bᵢ.

    One dense residual tree per client; the engine's uniform keep_local
    close composes it, its weighted close runs the ``perclient_fold``
    kernel and never builds this list.
    """
    ideal = product_mean(client_loras, weights)
    out = []
    for i in range(len(client_loras)):
        def fn(factor, ideal_leaf):
            own = torch.matmul(factor["a"].float(), factor["b"].float())
            return ideal_leaf - own
        # the walk is keyed on the FACTOR tree (first arg); the ideal tree
        # has plain tensor leaves at the factor positions
        out.append(map_factors(fn, client_loras[i], ideal))
    return out


def apply_residual(params: Params, residual: Params, scale: float) -> Params:
    """W0 ← W0 + scale·ΔW_res at every adapted kernel, and at every adapted
    raw tensor (MoE experts) (Eq. 14); functional (new W0 tensors,
    ``params`` untouched)."""

    def walk(p: Any, r: Any) -> Any:
        if r is None or not isinstance(p, dict):
            return p
        out = dict(p)
        for key, rv in r.items():
            if key not in p:
                continue
            pv = p[key]
            if isinstance(rv, torch.Tensor) and isinstance(pv, dict):
                out[key] = dict(pv, kernel=(pv["kernel"].float() + scale * rv
                                            ).to(pv["kernel"].dtype))
            elif isinstance(rv, torch.Tensor):  # a raw expert tensor
                out[key] = (pv.float() + scale * rv).to(pv.dtype)
            elif isinstance(rv, dict):
                out[key] = walk(pv, rv)
        return out

    return walk(params, residual)
