"""LoRA adapter state: target selection / init / merge.

Counterpart of ``repro/core/lora.py`` (same layout: ``a: (..., d_in, r)``,
``b: (..., r, d_out)``, ``ΔW = a @ b``; ``a`` ~ N(0, 0.02²), ``b`` = 0, so
the adapter starts as a no-op). The adapter tree mirrors the parameter tree
at the target projections, stacked layer axis included; with
``lora_experts`` also on every raw ≥ 3-D tensor under a MoE layer's
``experts`` (``{a: (L, E, d_in, r), b: (L, E, r, d_out)}``; ``include_mlp``
adapts only projection modules, never those). ``init_lora`` makes
the port's own draws from a ``torch.Generator``; the parity tests carry the
reference's draws across with :mod:`repro_torch.bridge` instead.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LoRAConfig, ModelConfig
from repro_torch.util.device import resolve_device

Params = Dict[str, Any]

# module names adapted per family when the user doesn't override targets
FAMILY_TARGETS = {
    "dense": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "vlm": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "encdec": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "moe": ("q_proj", "k_proj", "v_proj", "o_proj",
            "q_down", "q_up", "kv_down", "k_up", "v_up"),
    "hybrid": ("q_proj", "k_proj", "v_proj", "o_proj", "in_proj", "out_proj"),
    "ssm": ("q_proj", "k_proj", "v_proj", "up_proj", "down_proj", "w_gates"),
}
MLP_TARGETS = ("up_proj", "gate_proj", "down_proj")


def resolve_targets(cfg: ModelConfig, lora_cfg: LoRAConfig) -> Tuple[str, ...]:
    targets = tuple(lora_cfg.target_modules)
    if targets == LoRAConfig().target_modules:  # default → family-specific
        targets = FAMILY_TARGETS[cfg.family]
    if lora_cfg.include_mlp:
        targets = tuple(dict.fromkeys(targets + MLP_TARGETS))
    return targets


def init_lora(gen: torch.Generator, params: Params, cfg: ModelConfig,
              lora_cfg: LoRAConfig) -> Params:
    """Build the adapter tree mirroring ``params`` at target projections."""
    targets = set(resolve_targets(cfg, lora_cfg))
    r = lora_cfg.rank

    def make_factor(kernel: torch.Tensor) -> Params:
        *lead, d_in, d_out = kernel.shape
        a = torch.empty((*lead, d_in, r), dtype=torch.float32,
                        device=kernel.device)
        a.normal_(0.0, 0.02, generator=gen)
        b = torch.zeros((*lead, r, d_out), dtype=torch.float32,
                        device=kernel.device)
        return {"a": a, "b": b}

    def walk(node: Any) -> Optional[Params]:
        if not isinstance(node, dict):
            return None
        out = {}
        for key, child in node.items():
            if key in targets and isinstance(child, dict) and "kernel" in child:
                if child["kernel"].ndim >= 2:
                    out[key] = make_factor(child["kernel"])
            elif (key == "experts" and lora_cfg.lora_experts
                  and isinstance(child, dict)):
                sub = {ek: make_factor(ev) for ek, ev in child.items()
                       if isinstance(ev, torch.Tensor) and ev.ndim >= 3}
                if sub:
                    out[key] = sub
            elif isinstance(child, dict):
                sub = walk(child)
                if sub:
                    out[key] = sub
        return out or None

    return walk(params) or {}


def merge_lora(params: Params, lora: Params, scale: float) -> Params:
    """Fold adapters into kernels (and raw expert tensors): W ← W +
    scale·(a @ b). For eval/export."""

    def walk(p: Any, l: Any) -> Any:
        if l is None or not isinstance(p, dict):
            return p
        out = dict(p)
        for key, lv in l.items():
            if key not in p:
                continue
            pv = p[key]
            if isinstance(lv, dict) and "a" in lv and "b" in lv:
                delta = scale * torch.matmul(lv["a"], lv["b"])
                if isinstance(pv, dict):
                    out[key] = dict(pv, kernel=(pv["kernel"].float() + delta
                                                ).to(pv["kernel"].dtype))
                else:  # a raw expert tensor
                    out[key] = (pv.float() + delta).to(pv.dtype)
            elif isinstance(lv, dict):
                out[key] = walk(pv, lv)
        return out

    return walk(params, lora)


def init_global_state(model, lora_cfg: LoRAConfig, seed: int = 0,
                      device="cuda", *,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Params, Params]:
    """(params, global_lora) from one seed: one ``torch.Generator`` on the
    device seeded with ``seed``, ``model.init`` then :func:`init_lora` — the
    trainer's recipe, so that a federation server and its twin derive the
    same state from (arch, lora_cfg, seed). A given ``generator`` is drawn
    from instead (the trainer goes on drawing from it)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    params = model.init(gen, dev)
    return params, init_lora(gen, params, model.cfg, lora_cfg)
