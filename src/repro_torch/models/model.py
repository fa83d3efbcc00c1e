"""Model API: ``build_model(cfg) → Model`` (dense, vlm, MoE, hybrid, ssm
and encdec families).

Counterpart of ``repro/models/model.py``: a namespace of functions closed
over the config — ``init(gen, device) → params``, ``apply(params, batch,
lora=…) → logits`` (``with_aux=True``: ``(logits, aux)``, the reference's
return), ``loss(params, batch, lora=…) → (scalar, metrics)`` (a MoE
config's scalar is CE + the router aux loss, with ``metrics["aux_loss"]``),
``lane_loss(params, batch, lora=…) → (C,)`` for lane-stacked adapters
(mesh mode; every family, a MoE config's each lane's CE plus its own
router aux loss), and for serving ``init_cache(batch_size, cache_len, dtype, device) →
cache``,
``prefill(params, batch, cache, lora=…) → (logits, cache)`` and
``decode_step(params, tokens, cache, position, lora=…) → (logits, cache)``.
An encdec config (whisper) reads ``batch["frames"]`` (B, enc_seq_len,
d_model) beside the tokens in ``apply``, ``loss`` and ``prefill`` (its
loss is the CE alone; ``with_aux`` gives a zero aux, as the reference's);
``decode_step`` reads no frames; its ``lane_loss`` folds frames and
tokens lane-major alike. A vlm config (internvl2) reads
``batch.get("vision_embeds")`` (B, Vt, d_model) in ``apply`` and
``prefill``, the stubbed ViT's patch embeddings, which the model prepends
to the tokens; when a batch carries them, ``loss`` and ``lane_loss`` score
the text positions only (``logits[:, Vt:]``), as the reference's. A
batch without them (the federated loaders' tokens) trains it as a
text-only LM; ``decode_step`` reads tokens only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import cross_entropy
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    apply: Callable
    loss: Callable
    lane_loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


# leading stacked layer axes of an adapter leaf under each prefix (a
# leaf under none, as zamba2's ``shared_attn/``, has no layer axis)
STACKED_AXES = {"layers/": 1, "dense_layers/": 1, "periods/local/": 2,
                "periods/global/": 1, "periods/mlstm/": 2,
                "periods/slstm/": 1, "mamba_layers/": 2,
                "mamba_trailing/": 1, "encoder/": 1, "decoder/": 1}


def _stacked_axes(path: str) -> int:
    return next((n for prefix, n in STACKED_AXES.items()
                 if path.startswith(prefix)), 0)


def lanes_by_layer(lora) -> Tuple[int, Any]:
    """(C, the tree) of a lane-stacked adapter tree in the engine's layout
    (``(C, L, m, r)`` under ``layers``, ``(C, nper, ratio, m, r)`` under
    ``periods/local``, ``(C, m, r)`` under no stacked prefix, …) with each
    leaf's lane axis moved behind its stacked layer axes, so that a layer
    slices ``(C, m, r)`` (a per-expert leaf ``(C, E, m, r)``)."""
    flat = flatten_with_paths(lora)
    c = next(iter(flat.values())).shape[0]
    return c, unflatten_from_paths({
        p: x.movedim(0, _stacked_axes(p)) for p, x in flat.items()})


def _lane_ce(logits, batch, c: int) -> torch.Tensor:
    """Each lane's mean CE, (C,): lane c owns rows ``[c·B, (c+1)·B)``."""
    logits = logits.reshape(c, -1, *logits.shape[1:])
    targets = batch["targets"].reshape(c, -1, *batch["targets"].shape[1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.reshape(c, -1, *mask.shape[1:])
    return torch.stack([
        cross_entropy(logits[i], targets[i],
                      None if mask is None else mask[i])[0]
        for i in range(c)])


def build_model(cfg, moe_impl: str = "ragged") -> Model:
    """``moe_impl``: a MoE config's expert path, ``"ragged"`` (grouped by
    expert) or ``"dense"`` (every expert on every token, the oracle)."""
    transformer.check_supported(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    moe = cfg.family == "moe"

    def init(gen, device):
        return transformer.make_params(gen, cfg, device)

    def apply(params, batch, lora=None, lora_scale=0.0, with_aux=False):
        return transformer.forward(cfg, params, batch["tokens"], lora=lora,
                                   lora_scale=lora_scale, moe_impl=moe_impl,
                                   with_aux=with_aux,
                                   extra_embeds=batch.get("vision_embeds"))

    def text_logits(logits, batch):
        """A vlm batch's logits over its text positions: the vision
        prefix's are not scored (the reference's ``logits[:, vt:]``)."""
        if cfg.family == "vlm" and "vision_embeds" in batch:
            return logits[:, batch["vision_embeds"].shape[1]:]
        return logits

    def loss(params, batch, lora=None, lora_scale=0.0):
        out = apply(params, batch, lora=lora, lora_scale=lora_scale,
                    with_aux=moe)
        logits = text_logits(out[0] if moe else out, batch)
        ce, metrics = cross_entropy(logits, batch["targets"],
                                    batch.get("loss_mask"))
        metrics = dict(metrics)
        total = ce
        if moe:
            total = ce + out[1]
            metrics["aux_loss"] = out[1]
        metrics["total_loss"] = total
        return total, metrics

    def lane_loss(params, batch, lora, lora_scale=0.0):
        """Each lane's mean loss, (C,), from one forward over the folded
        batch: ``lora`` holds lane-stacked factors in the engine's layout
        (:func:`lanes_by_layer`) and lane c owns batch rows
        ``[c·B, (c+1)·B)`` (a vlm batch's ``vision_embeds`` rows too; its
        text positions scored only). A MoE config's loss is each lane's CE
        plus that lane's own router aux loss, f and p̄ over its rows
        alone, as the reference's loss mapped over the lanes."""
        c, by_layer = lanes_by_layer(lora)
        out = transformer.forward(
            cfg, params, batch["tokens"], lora=by_layer,
            lora_scale=lora_scale, moe_impl=moe_impl, with_aux=moe,
            extra_embeds=batch.get("vision_embeds"), lanes=c)
        ce = _lane_ce(text_logits(out[0] if moe else out, batch), batch, c)
        return ce + out[1] if moe else ce

    def init_cache(batch_size, cache_len, dtype=torch.bfloat16,
                   device="cuda"):
        return transformer.init_cache(cfg, batch_size, cache_len, dtype,
                                      device)

    def prefill(params, batch, cache, lora=None, lora_scale=0.0):
        return transformer.forward(cfg, params, batch["tokens"], lora=lora,
                                   lora_scale=lora_scale, mode="prefill",
                                   cache=cache, moe_impl=moe_impl,
                                   extra_embeds=batch.get("vision_embeds"))

    def decode_step(params, tokens, cache, position, lora=None,
                    lora_scale=0.0):
        return transformer.forward(cfg, params, tokens, lora=lora,
                                   lora_scale=lora_scale, mode="decode",
                                   cache=cache, position=position,
                                   moe_impl=moe_impl)

    return Model(cfg=cfg, init=init, apply=apply, loss=loss,
                 lane_loss=lane_loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)


def _build_encdec(cfg) -> Model:
    """The encdec family's namespace (the reference's ``model.py:45–74``):
    :mod:`repro_torch.models.encdec`'s encoder over ``batch["frames"]``,
    then its decoder; ``prefill`` encodes through the serving kernels."""

    def init(gen, device):
        return encdec.make_params(gen, cfg, device)

    def apply(params, batch, lora=None, lora_scale=0.0, with_aux=False):
        enc = encdec.encode(cfg, params, batch["frames"], lora=lora,
                            lora_scale=lora_scale)
        logits = encdec.decoder_forward(cfg, params, batch["tokens"], enc,
                                        lora=lora, lora_scale=lora_scale)
        if not with_aux:
            return logits
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def loss(params, batch, lora=None, lora_scale=0.0):
        ce, metrics = cross_entropy(
            apply(params, batch, lora=lora, lora_scale=lora_scale),
            batch["targets"], batch.get("loss_mask"))
        return ce, dict(metrics, total_loss=ce)

    def lane_loss(params, batch, lora, lora_scale=0.0):
        """Each lane's mean CE, (C,), from one pass of the encoder over the
        folded frames and of the decoder over the folded tokens: lane c
        owns rows ``[c·B, (c+1)·B)`` of both, its factors
        (:func:`lanes_by_layer`) apply to them in every encoder and
        decoder layer, its cross-attention reads its own frames'
        encoding."""
        c, by_layer = lanes_by_layer(lora)
        return _lane_ce(apply(params, batch, lora=by_layer,
                              lora_scale=lora_scale), batch, c)

    def init_cache(batch_size, cache_len, dtype=torch.bfloat16,
                   device="cuda"):
        return encdec.init_cache(cfg, batch_size, cache_len, dtype, device)

    def prefill(params, batch, cache, lora=None, lora_scale=0.0):
        enc = encdec.encode(cfg, params, batch["frames"], lora=lora,
                            lora_scale=lora_scale, fused=True)
        return encdec.decoder_forward(cfg, params, batch["tokens"], enc,
                                      lora=lora, lora_scale=lora_scale,
                                      mode="prefill", cache=cache)

    def decode_step(params, tokens, cache, position, lora=None,
                    lora_scale=0.0):
        return encdec.decoder_forward(cfg, params, tokens, None, lora=lora,
                                      lora_scale=lora_scale, mode="decode",
                                      cache=cache, position=position)

    return Model(cfg=cfg, init=init, apply=apply, loss=loss,
                 lane_loss=lane_loss, init_cache=init_cache, prefill=prefill,
                 decode_step=decode_step)
