"""Model API: ``build_model(cfg) → Model`` (dense family, training path).

Counterpart of ``repro/models/model.py``: a namespace of functions closed
over the config — ``init(gen, device) → params``, ``apply(params, batch,
lora=…) → logits`` and ``loss(params, batch, lora=…) → (scalar, metrics)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.models import transformer
from repro_torch.models.common import cross_entropy


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    apply: Callable
    loss: Callable


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

    return Model(cfg=cfg, init=init, apply=apply, loss=loss)
