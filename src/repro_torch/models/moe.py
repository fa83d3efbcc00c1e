"""Mixture-of-Experts block: top-k router, load-balance aux loss and the
expert FFN, the counterpart of ``repro/models/moe.py``.

Two paths share one set of parameters:

* ``ragged`` (default): the routed rows sorted by expert (a stable sort, as
  ``jnp.argsort``), then each expert's contiguous group of rows through its
  up, gate and down projections. The reference's ``jax.lax.ragged_dot`` is
  a grouped product; here it is a loop over the E groups with one product
  each, which needs the group sizes on the host (one sync a MoE layer).
  Each group's projection is :func:`~repro_torch.models.common.project`
  with that expert's W and adapter: ``x@W + s·(x@a)@b``, the reference's
  ``ragged(x, W) + s·ragged(ragged(x, a), b)`` with the same rounding
  points; with ``fused`` (serving) and an expert adapter, the fused LoRA
  kernel (B3) on the card. Training keeps the plain products (B3 has no
  backward).
* ``dense``: every expert on every token, the routing weights folded into
  the down projection: the oracle the tests hold the ragged path against.

The aux loss is Switch/Mixtral's ``E · Σ_e f_e · p̄_e · coef``; it carries
a gradient through p̄. Per-expert adapters (``LoRAConfig.lora_experts``)
are ``{a: (E, d_in, r), b: (E, r, d_out)}`` on the raw expert tensors.

Mesh mode's lanes (``lanes`` = C co-scheduled clients, the rows of x
folded lane-major, T/C rows a lane): f and p̄ are taken over each lane's
rows alone, so the aux loss is (C,), each lane's own (the reference maps
the loss over the lanes). Per-expert adapters are then ``(C, E, d_in, r)``
and ``(C, E, r, d_out)``: the ragged path splits each expert's group into
its lanes' subgroups, the dense oracle carries a lane axis in its
einsums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, activation, make_dense_params,
                                       project, stacked_normal)
from repro_torch.models.mlp import make_mlp_params, mlp_block

IMPLS = ("ragged", "dense")


def make_moe_params(gen, cfg, dtype, device, lead=()) -> Params:
    """The router ``{kernel: (*lead, d, E)}``, the raw expert stacks
    ``experts/{up,gate}_proj (*lead, E, d, ff)`` and ``down_proj (*lead, E,
    ff, d)`` (ff = ``moe_d_ff`` or ``d_ff``), and with
    ``num_shared_experts`` a gated ``shared`` MLP of ff × that count."""
    d, e = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": make_dense_params(gen, (*lead, d, e), dtype, device),
        "experts": {
            "up_proj": stacked_normal(gen, (*lead, e, d, ff), lead, dtype,
                                       device),
            "gate_proj": stacked_normal(gen, (*lead, e, d, ff), lead, dtype,
                                         device),
            "down_proj": stacked_normal(gen, (*lead, e, ff, d), lead, dtype,
                                         device),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = make_mlp_params(gen, cfg, dtype, device, lead,
                                      d_ff=ff * cfg.num_shared_experts,
                                      gated=True)
    return p


def router_topk(cfg, router_params: Params, x: torch.Tensor,
                lanes: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) → (top-k weights (T, k) f32, expert indices (T, k), aux
    loss scalar). The logits are x's dtype cast to f32 (a bf16 model's are
    rounded to bf16 first, as the reference's), the softmax f32. Among equal
    probabilities the lower expert index comes first, as ``lax.top_k``
    orders them (``torch.topk`` does not): a stable descending sort. With
    ``lanes`` the aux loss is (lanes,), each over its block of T/lanes
    rows."""
    logits = torch.matmul(x, router_params["kernel"]).float()
    probs = torch.softmax(logits, dim=-1)
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    top_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = top_p[:, :k], order[:, :k]
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    # load balance: E · Σ_e (share of the routed slots at e) · (mean prob e)
    one_hot = F.one_hot(topk_idx, e).float().sum(dim=1)  # (T, E)
    if lanes:
        one_hot = one_hot.reshape(lanes, -1, e)
        probs = probs.reshape(lanes, -1, e)
    f = one_hot.mean(dim=-2) / k
    pbar = probs.mean(dim=-2)
    aux = e * torch.sum(f * pbar, dim=-1) * cfg.router_aux_loss_coef
    return topk_w, topk_idx, aux


def _expert_adapter(lora: Optional[Params], name: str, g: int,
                    lane: Optional[int] = None) -> Optional[Params]:
    """Expert g's factors (lane ``lane``'s, under lanes)."""
    le = (lora or {}).get("experts") or {}
    if name not in le:
        return None
    idx = g if lane is None else (lane, g)
    return {"a": le[name]["a"][idx], "b": le[name]["b"][idx]}


def _with_lanes(spec: str) -> str:
    """An einsum spec with a leading lane axis on every operand and on the
    output: ``"td,edr->ter"`` → ``"ctd,cedr->cter"``."""
    ins, out = spec.split("->")
    return ",".join("c" + x for x in ins.split(",")) + "->c" + out


def _expert_ffn_dense(cfg, experts: Params, x: torch.Tensor,
                      w_full: torch.Tensor, lora: Optional[Params],
                      lora_scale: float, lanes: Optional[int] = None
                      ) -> torch.Tensor:
    """x (T, d), routing weights (T, E) → (T, d): every expert on every
    token, the weights applied to the hidden (T, E, ff) before the down
    projection, which reduces over the experts. With ``lanes`` the expert
    adapters are lane-stacked and lane c's apply to its block of rows."""
    le = (lora or {}).get("experts") or {}

    def term(inp, name, first, second):
        """s·(inp@a)@b over the experts, ``first`` and ``second`` the two
        products' einsum specs without a lane axis."""
        a, b = (le[name][f].to(x.dtype) for f in ("a", "b"))
        if not lanes:
            return lora_scale * torch.einsum(
                second, torch.einsum(first, inp, a), b)
        lane = inp.reshape(lanes, -1, *inp.shape[1:])
        out = torch.einsum(_with_lanes(second), torch.einsum(
            _with_lanes(first), lane, a), b)
        return lora_scale * out.reshape(-1, *out.shape[2:])

    up = torch.einsum("td,edf->tef", x, experts["up_proj"])
    gate = torch.einsum("td,edf->tef", x, experts["gate_proj"])
    if "up_proj" in le:
        up = up + term(x, "up_proj", "td,edr->ter", "ter,erf->tef")
    if "gate_proj" in le:
        gate = gate + term(x, "gate_proj", "td,edr->ter", "ter,erf->tef")
    h = activation(cfg.act, gate) * up
    hw = h * w_full[..., None].to(h.dtype)  # routing-weighted (T, E, ff)
    y = torch.einsum("tef,efd->td", hw, experts["down_proj"])
    if "down_proj" in le:
        y = y + term(hw, "down_proj", "tef,efr->ter", "ter,erd->td")
    return y


def _expert_ffn_ragged(cfg, experts: Params, x_sorted: torch.Tensor,
                       group_sizes: torch.Tensor, lora: Optional[Params],
                       lora_scale: float, fused: bool) -> torch.Tensor:
    """Rows sorted by expert, ``group_sizes`` (E,) → (T·k, d): expert g's
    FFN on its contiguous rows, an empty group skipped. ``group_sizes``
    (E, C) (lanes with per-expert adapters): expert g's rows are C
    lane-major subgroups, lane c's through lane c's factors of expert
    g."""
    out, start = [], 0
    for g, sizes in enumerate(group_sizes.tolist()):  # the host sync
        subgroups = (enumerate(sizes) if isinstance(sizes, list)
                     else ((None, sizes),))
        for lane, n in subgroups:
            if not n:
                continue
            xg = x_sorted[start:start + n]
            start += n

            def proj(inp, name):
                return project(inp, {"kernel": experts[name][g]},
                               _expert_adapter(lora, name, g, lane),
                               lora_scale, fused)

            h = (activation(cfg.act, proj(xg, "gate_proj"))
                 * proj(xg, "up_proj"))
            out.append(proj(h, "down_proj"))
    return torch.cat(out)


def moe_block(cfg, params: Params, x: torch.Tensor, *,
              lora: Optional[Params] = None, lora_scale: float = 0.0,
              impl: str = "ragged", fused: bool = False,
              lanes: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss). ``fused`` (serving): the
    adapted projections run the fused LoRA kernel, the expert groups' and
    the shared MLP's alike. ``lanes`` (mesh mode): B is lanes blocks of
    rows, lane-major; the aux loss is (lanes,) and lane-stacked adapters
    apply lane by lane."""
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r} (expected one of "
                         f"{IMPLS})")
    b, s, d = x.shape
    t, k, e = b * s, cfg.num_experts_per_tok, cfg.num_experts
    xf = x.reshape(t, d)
    topk_w, topk_idx, aux = router_topk(cfg, params["router"], xf, lanes)

    if impl == "dense":
        w_full = (F.one_hot(topk_idx, e).float()
                  * topk_w[..., None]).sum(dim=1)  # (T, E)
        y = _expert_ffn_dense(cfg, params["experts"], xf, w_full, lora,
                              lora_scale, lanes)
    else:
        flat_expert = topk_idx.reshape(t * k)
        sort_idx = torch.argsort(flat_expert, stable=True)
        token_idx = sort_idx // k  # the token each sorted row came from
        if lanes and (lora or {}).get("experts"):
            # the stable sort keeps each expert's rows in token order, so
            # lane-major: one count a (expert, lane) subgroup
            lane = torch.arange(t * k, device=x.device) // (k * t // lanes)
            sizes = torch.bincount(flat_expert * lanes + lane,
                                   minlength=e * lanes).reshape(e, lanes)
        else:
            sizes = torch.bincount(flat_expert, minlength=e)
        y_sorted = _expert_ffn_ragged(
            cfg, params["experts"], xf[token_idx], sizes, lora, lora_scale,
            fused)
        w_sorted = topk_w.reshape(t * k)[sort_idx]
        y_weighted = y_sorted * w_sorted[:, None].to(y_sorted.dtype)
        # combine: scatter-add back onto the tokens, in y's dtype
        y = torch.zeros((t, d), dtype=y_sorted.dtype,
                        device=x.device).index_add(0, token_idx, y_weighted)

    if "shared" in params:
        y = y + mlp_block(cfg, params["shared"], xf,
                          lora=(lora or {}).get("shared"),
                          lora_scale=lora_scale, fused=fused)
    return y.reshape(b, s, d), aux
