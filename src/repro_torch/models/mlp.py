"""Feed-forward block: the gated (SwiGLU) and plain 2-layer MLPs of
``repro/models/mlp.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (Params, activation,
                                       make_dense_params, maybe_lora, project)


def make_mlp_params(gen, cfg, dtype, device, lead=(), *, d_ff: int = 0,
                    gated: Optional[bool] = None) -> Params:
    """Hidden width ``d_ff`` (0: ``cfg.d_ff``); gated iff ``gated``, or
    when it is None iff ``cfg.act == "silu"``; up/down carry biases iff
    ``cfg.qkv_bias`` and LayerNorm (the reference's conditions)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.act == "silu" if gated is None else gated
    bias = cfg.qkv_bias and cfg.norm == "layernorm"
    p = {
        "up_proj": make_dense_params(gen, (*lead, d, ff), dtype, device,
                                     bias=bias),
        "down_proj": make_dense_params(gen, (*lead, ff, d), dtype, device,
                                       bias=bias),
    }
    if gated:
        p["gate_proj"] = make_dense_params(gen, (*lead, d, ff), dtype, device)
    return p


def mlp_block(cfg, params: Params, x: torch.Tensor, *,
              lora: Optional[Params] = None, lora_scale: float = 0.0,
              fused: bool = False) -> torch.Tensor:
    """``down(act(gate(x)) · up(x))``, or ``down(act(up(x)))`` without a
    gate. ``fused`` (serving): adapted projections (``include_mlp``) run
    the fused LoRA kernel."""
    def proj(inp, name):
        return project(inp, params[name], maybe_lora(lora, name), lora_scale,
                       fused)

    up = proj(x, "up_proj")
    if "gate_proj" in params:
        h = activation(cfg.act, proj(x, "gate_proj")) * up
    else:
        h = activation(cfg.act, up)
    return proj(h, "down_proj")
