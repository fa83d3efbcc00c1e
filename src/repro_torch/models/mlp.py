"""Feed-forward block: the gated SiLU (SwiGLU) branch of ``repro/models/mlp.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (Params, activation,
                                       make_dense_params, maybe_lora, project)


def make_mlp_params(gen, cfg, dtype, device, lead=()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "up_proj": make_dense_params(gen, (*lead, d, ff), dtype, device),
        "down_proj": make_dense_params(gen, (*lead, ff, d), dtype, device),
        "gate_proj": make_dense_params(gen, (*lead, d, ff), dtype, device),
    }


def mlp_block(cfg, params: Params, x: torch.Tensor, *,
              lora: Optional[Params] = None, lora_scale: float = 0.0,
              fused: bool = False) -> torch.Tensor:
    """``fused`` (serving): adapted projections (``include_mlp``) run the
    fused LoRA kernel."""
    def proj(inp, name):
        return project(inp, params[name], maybe_lora(lora, name), lora_scale,
                       fused)

    h = activation(cfg.act, proj(x, "gate_proj")) * proj(x, "up_proj")
    return proj(h, "down_proj")
