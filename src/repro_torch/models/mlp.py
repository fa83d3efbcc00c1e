"""Feed-forward block: the gated SiLU (SwiGLU) branch of ``repro/models/mlp.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (Params, activation, dense,
                                       make_dense_params, maybe_lora)


def make_mlp_params(gen, cfg, dtype, device, lead=()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "up_proj": make_dense_params(gen, (*lead, d, ff), dtype, device),
        "down_proj": make_dense_params(gen, (*lead, ff, d), dtype, device),
        "gate_proj": make_dense_params(gen, (*lead, d, ff), dtype, device),
    }


def mlp_block(cfg, params: Params, x: torch.Tensor, *,
              lora: Optional[Params] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    up = dense(x, params["up_proj"], maybe_lora(lora, "up_proj"), lora_scale)
    gate = dense(x, params["gate_proj"], maybe_lora(lora, "gate_proj"),
                 lora_scale)
    h = activation(cfg.act, gate) * up
    return dense(h, params["down_proj"], maybe_lora(lora, "down_proj"),
                 lora_scale)
