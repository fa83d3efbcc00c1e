"""Model API: ``build_model(cfg) → Model`` (dense family).

Counterpart of ``repro/models/model.py``: a namespace of functions closed
over the config — ``init(gen, device) → params``, ``apply(params, batch,
lora=…) → logits``, ``loss(params, batch, lora=…) → (scalar, metrics)``, and
for serving ``init_cache(batch_size, cache_len, dtype, device) → cache``,
``prefill(params, batch, cache, lora=…) → (logits, cache)`` and
``decode_step(params, tokens, cache, position, lora=…) → (logits, cache)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.common import cross_entropy


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    apply: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def build_model(cfg) -> Model:
    transformer.check_supported(cfg)

    def init(gen, device):
        return transformer.make_params(gen, cfg, device)

    def apply(params, batch, lora=None, lora_scale=0.0):
        return transformer.forward(cfg, params, batch["tokens"], lora=lora,
                                   lora_scale=lora_scale)

    def loss(params, batch, lora=None, lora_scale=0.0):
        logits = apply(params, batch, lora=lora, lora_scale=lora_scale)
        ce, metrics = cross_entropy(logits, batch["targets"],
                                    batch.get("loss_mask"))
        metrics = dict(metrics)
        metrics["total_loss"] = ce
        return ce, metrics

    def init_cache(batch_size, cache_len, dtype=torch.bfloat16,
                   device="cuda"):
        return transformer.init_cache(cfg, batch_size, cache_len, dtype,
                                      device)

    def prefill(params, batch, cache, lora=None, lora_scale=0.0):
        return transformer.forward(cfg, params, batch["tokens"], lora=lora,
                                   lora_scale=lora_scale, mode="prefill",
                                   cache=cache)

    def decode_step(params, tokens, cache, position, lora=None,
                    lora_scale=0.0):
        return transformer.forward(cfg, params, tokens, lora=lora,
                                   lora_scale=lora_scale, mode="decode",
                                   cache=cache, position=position)

    return Model(cfg=cfg, init=init, apply=apply, loss=loss,
                 init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)
