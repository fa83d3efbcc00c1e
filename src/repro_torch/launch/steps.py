"""Serving step functions: the counterparts of ``make_prefill_step`` and
``make_decode_step`` in ``repro/launch/steps.py`` (the port's training step
is ``core/federated.py::make_local_step``). Eager PyTorch: there is no jit;
call them under ``torch.inference_mode()``. They run in the dtype the
params hold (the model's: bf16 by default, as the reference serves), the
serving kernels in that dtype too; the logits come back in float32, as the
reference's unembedding returns them."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs import LoRAConfig


def make_prefill_step(model, lora_cfg: LoRAConfig) -> Callable:
    """``prefill_step(params, lora, batch, cache) → (logits (B, 1, V),
    cache)``: serving keeps only the last position's logits (a copy, so the
    full (B, S, V) logits are freed)."""
    scale = lora_cfg.scale

    def prefill_step(params, lora, batch, cache):
        logits, cache = model.prefill(params, batch, cache, lora=lora,
                                      lora_scale=scale)
        return logits[:, -1:].contiguous(), cache

    return prefill_step


def make_decode_step(model, lora_cfg: LoRAConfig) -> Callable:
    """``decode_step(params, lora, tokens (B, 1), cache, position) →
    (next tokens (B, 1) int32 by argmax, logits (B, 1, V), cache)``."""
    scale = lora_cfg.scale

    def decode_step(params, lora, tokens, cache, position):
        logits, cache = model.decode_step(params, tokens, cache, position,
                                          lora=lora, lora_scale=scale)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return decode_step
