"""Residual decomposition — the paper's communication protocol (§4.2).

Counterpart of ``repro/core/decompose.py``. ``ΔW_res = Σwᵢ aᵢbᵢ − ā b̄`` has
rank ≤ (k+1)·r by construction, so the server never ships the dense m×n
matrix:

* ``residual_factors`` — the exact factored form L: (m, (k+1)r),
  R: ((k+1)r, n) with ΔW_res = L @ R (the client factors concatenated);
* ``truncated_svd_product`` — the rank-r' truncation without forming the
  dense residual: QR of L, SVD of the small (p × n) matrix R_q @ R; by
  Eckart–Young (Eq. 15–16) the optimal rank-r' approximation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.aggregation import normalize_weights

Params = Dict[str, Any]


def residual_factors(client_factors: List[Params], weights=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact low-rank factorisation of one matrix's residual.

    client_factors: list of {"a": (m, r), "b": (r, n)}. Returns
    (L (m, (k+1)r), R ((k+1)r, n)) with L @ R == ΔW_res; L carries wᵢ·aᵢ
    columns and −ā, R the bᵢ rows and b̄.
    """
    k = len(client_factors)
    w = normalize_weights(weights, k)
    if w is None:
        w = [1.0 / k] * k
    a_bar = sum(wi * f["a"].float() for wi, f in zip(w, client_factors))
    b_bar = sum(wi * f["b"].float() for wi, f in zip(w, client_factors))
    lefts = [wi * f["a"].float() for wi, f in zip(w, client_factors)]
    rights = [f["b"].float() for f in client_factors]
    L = torch.cat(lefts + [-a_bar], dim=-1)
    R = torch.cat(rights + [b_bar], dim=-2)
    return L, R


def truncated_svd_product(L: torch.Tensor, R: torch.Tensor, rank: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimal rank-``rank`` approximation of ``L @ R`` without densifying.

    Returns (U (m, rank), s (rank,), Vt (rank, n)) with L@R ≈ U diag(s) Vt.
    """
    q, r_small = torch.linalg.qr(L)        # q: (m, p), r_small: (p, p)
    mid = r_small @ R                      # (p, n)
    u_mid, s, vt = torch.linalg.svd(mid, full_matrices=False)
    u = q @ u_mid
    return u[:, :rank], s[:rank], vt[:rank]


def reconstruct(u: torch.Tensor, s: torch.Tensor,
                vt: torch.Tensor) -> torch.Tensor:
    return (u * s) @ vt


def factored_residual_params(m: int, n: int, r: int, k: int) -> int:
    """Parameters transmitted for one matrix's exact factored residual."""
    p = (k + 1) * r
    return m * p + p * n


def truncated_residual_params(m: int, n: int, rank: int) -> int:
    return m * rank + rank + rank * n
