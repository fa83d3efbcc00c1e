"""Communication accounting (paper §6, Table 6).

Counterpart of ``repro/core/comm.py``: parameters transmitted per
aggregation round for each method, given the set of adapted matrices.
Uplink (clients → server) is the same for every LoRA method,
k · Σ (m·r + r·n). Downlink differs:

* FedIT:      Σ (m·r + r·n) broadcast to k clients
* FFA-LoRA:   Σ (r·n) — only b (a frozen), both ways
* FedEx-LoRA: FedIT downlink + the factored residual (rank ≤ (k+1)r;
              ``repro_torch.core.decompose``) — Table 6's "marginal overhead"
* FedEx-SVD:  FedIT downlink + the truncated rank-r' residual factors
* full FT:    Σ m·n both directions
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.decompose import (factored_residual_params,
                                        truncated_residual_params)


@dataclass(frozen=True)
class MatrixSpec:
    name: str
    m: int
    n: int


def adapted_matrices(cfg, lora_cfg) -> List[MatrixSpec]:
    """The matrices that carry adapters for a decoder-style config, expanded
    over layers: attention q/k/v/o, and the MLP if configured."""
    hd = cfg.resolved_head_dim
    per_layer = [
        MatrixSpec("q_proj", cfg.d_model, cfg.num_heads * hd),
        MatrixSpec("k_proj", cfg.d_model, cfg.num_kv_heads * hd),
        MatrixSpec("v_proj", cfg.d_model, cfg.num_kv_heads * hd),
        MatrixSpec("o_proj", cfg.num_heads * hd, cfg.d_model),
    ]
    if lora_cfg.include_mlp and cfg.d_ff:
        per_layer += [
            MatrixSpec("up_proj", cfg.d_model, cfg.d_ff),
            MatrixSpec("gate_proj", cfg.d_model, cfg.d_ff),
            MatrixSpec("down_proj", cfg.d_ff, cfg.d_model),
        ]
    return [MatrixSpec(f"layer{layer}/{ms.name}", ms.m, ms.n)
            for layer in range(cfg.num_layers) for ms in per_layer]


def participating_clients(k: int, participation_fraction: float,
                          min_clients: int = 1) -> int:
    """⌈fraction·k⌉ clamped to [min_clients, k] — the coordinator's round
    sampler (pass min_clients = its min_quorum to stay aligned when the
    quorum floor exceeds the sampled fraction)."""
    if not 0.0 < participation_fraction <= 1.0:
        raise ValueError(f"participation_fraction must be in (0, 1], "
                         f"got {participation_fraction}")
    return min(k, max(1, min_clients, math.ceil(participation_fraction * k)))


def round_comm_params(method: str, mats: List[MatrixSpec], r: int, k: int,
                      svd_rank: int = 0,
                      participation_fraction: float = 1.0,
                      min_clients: int = 1,
                      participants: Optional[int] = None) -> Dict[str, int]:
    """Parameters communicated in ONE aggregation round.

    Only the k_p = ⌈fraction·k⌉ sampled clients exchange traffic, and the
    FedEx factored residual's rank bound tightens to (k_p+1)·r.
    ``participants`` pins k_p to an observed delivered-client count.
    """
    if participants is not None:
        if not 1 <= participants <= k:
            raise ValueError(f"participants must be in [1, {k}], "
                             f"got {participants}")
        k_p = int(participants)
    else:
        k_p = participating_clients(k, participation_fraction, min_clients)
    adapters = sum(ms.m * r + r * ms.n for ms in mats)
    full = sum(ms.m * ms.n for ms in mats)

    if method == "full_ft":
        up = down = k_p * full
    elif method == "fedit":
        up = down = k_p * adapters
    elif method == "ffa":
        up = down = k_p * sum(r * ms.n for ms in mats)
    elif method == "fedex":
        up = k_p * adapters
        residual = sum(factored_residual_params(ms.m, ms.n, r, k_p)
                       for ms in mats)
        down = k_p * (adapters + residual)
    elif method == "fedex_svd":
        up = k_p * adapters
        residual = sum(truncated_residual_params(ms.m, ms.n, svd_rank or r)
                       for ms in mats)
        down = k_p * (adapters + residual)
    else:
        raise ValueError(f"unknown method {method!r}")
    return {"uplink": up, "downlink": down, "total": up + down}


def comm_table(cfg, lora_cfg, k: int, rounds: int, svd_rank: int = 0,
               participation_fraction: float = 1.0
               ) -> Dict[str, Dict[str, float]]:
    """Table-6 style: per-method totals over ``rounds`` + ratio to FedEx."""
    mats = adapted_matrices(cfg, lora_cfg)
    methods = ["full_ft", "fedex", "fedit", "ffa", "fedex_svd"]
    totals = {m: rounds * round_comm_params(
        m, mats, lora_cfg.rank, k, svd_rank,
        participation_fraction=participation_fraction)["total"]
        for m in methods}
    base = totals["fedex"]
    return {m: {"params": totals[m], "ratio_to_fedex": totals[m] / base}
            for m in methods}
