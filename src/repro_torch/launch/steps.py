"""Step builders shared by the dry run, the trainer and the server: the
counterparts of ``repro/launch/steps.py``'s ``train_step`` /
``prefill_step`` / ``decode_step`` closures, its ``input_specs`` factory for
every (arch × input shape) and its abstract state and cache.

Eager PyTorch: there is no jit. The abstract inputs, state and cache are
tensors on the meta device (shapes and dtypes, nothing allocated), built
by the port's own ``init``, ``init_lora`` and ``init_cache``; the dry run
(:mod:`repro_torch.launch.dryrun`) runs the steps on them under
:mod:`repro_torch.launch.cost`'s counter. The serving steps run in the
dtype the params hold (the model's: bf16 by default, as the reference
serves), the serving kernels in that dtype too; call them under
``torch.inference_mode()``. The logits come back in float32, as the
reference's unembedding returns them. The federated trainers' local step
is ``core/federated.py::make_local_step``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import LoRAConfig, ModelConfig, ShapeConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core.federated import clip_and_adamw, lora_grads
from repro_torch.core.lora import init_lora
from repro_torch.optim import init_adamw, lr_at
from repro_torch.util.cost import Loop
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input, on ``device`` (meta: no
    allocation; elsewhere uninitialised memory), with the reference's keys,
    shapes and dtypes.

    Decode shapes describe ONE decode step: tokens (B, 1) (the cache is
    built separately, :func:`abstract_cache`)."""
    gb, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.is_decode:
        return {"tokens": spec((gb, 1), torch.int32)}

    text_len = s
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        text_len = s - cfg.vision_tokens
        batch["vision_embeds"] = spec((gb, cfg.vision_tokens, cfg.d_model),
                                      torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = spec((gb, cfg.enc_seq_len, cfg.d_model),
                               torch.float32)
    batch["tokens"] = spec((gb, text_len), torch.int32)
    if shape.kind == "train":
        batch["targets"] = spec((gb, text_len), torch.int32)
        batch["loss_mask"] = spec((gb, text_len), torch.float32)
    return batch


def random_inputs(cfg: ModelConfig, shape: ShapeConfig, device,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
    """:func:`input_specs` filled with data drawn from ``seed`` on
    ``device``: tokens and targets uniform over the vocabulary, every
    position scored, embeddings and frames N(0, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for k, x in input_specs(cfg, shape).items():
        if x.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, x.shape, generator=gen,
                                   dtype=x.dtype, device=device)
        elif k == "loss_mask":
            out[k] = torch.ones(x.shape, dtype=x.dtype, device=device)
        else:
            out[k] = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                 device=device)
    return out


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def make_train_step(model, lora_cfg: LoRAConfig, train_cfg: TrainConfig,
                    num_microbatches: int = 1) -> Callable:
    """LoRA fine-tuning step: gradients w.r.t. the adapters only, W0 frozen.
    ``train_step(params, lora, opt_state, batch, step) → (lora, opt_state,
    loss, gnorm)``. The federated local step's gradient, clip and AdamW
    (``core/federated.py``'s ``lora_grads`` and ``clip_and_adamw``) at
    ``lr_at``'s schedule at ``step``.

    With ``num_microbatches > 1`` the global batch is split along its rows
    and the gradients accumulate in f32 over the microbatches, then are
    divided by their count (the reference's ``lax.scan``: the activation
    memory lever for train_4k at global batch 256)."""
    scale = lora_cfg.scale

    def train_step(params, lora, opt_state, batch, step):
        n = num_microbatches
        if n > 1:
            mbs = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
                   for k, x in batch.items()}
            grads = {p: torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device)
                     for p, x in flatten_with_paths(lora).items()}
            loss = torch.zeros((), dtype=torch.float32, device=grads[
                next(iter(grads))].device)
            for i in Loop(n, loss.device, first=0, last=0):
                mb_loss, g = lora_grads(model, params, lora,
                                        {k: x[i] for k, x in mbs.items()},
                                        scale)
                grads = {p: grads[p] + x.float()
                         for p, x in flatten_with_paths(g).items()}
                loss = loss + mb_loss
                del g
            grads = unflatten_from_paths({p: x / n for p, x in grads.items()})
            loss = loss / n
        else:
            loss, grads = lora_grads(model, params, lora, batch, scale)
        lr = lr_at(step, base_lr=train_cfg.learning_rate,
                   total_steps=train_cfg.total_steps,
                   warmup_ratio=train_cfg.warmup_ratio,
                   kind=train_cfg.schedule)
        lora, opt_state, gnorm = clip_and_adamw(grads, opt_state, lora, lr,
                                                train_cfg)
        return lora, opt_state, loss, gnorm

    return train_step


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


# --------------------------------------------------------------------------
# abstract state
# --------------------------------------------------------------------------

def abstract_state(model, cfg: ModelConfig, lora_cfg: LoRAConfig,
                   device="meta") -> Tuple[Any, Any, Any]:
    """(params, lora, opt_state) on ``device`` (meta: no allocation), built
    by the model's ``init``, ``init_lora`` and ``init_adamw`` from one
    seed-0 generator (the CPU's for the meta device)."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    lora = init_lora(gen, params, cfg, lora_cfg)
    return params, lora, init_adamw(lora)


def abstract_cache(model, batch_size: int, cache_len: int,
                   dtype=torch.bfloat16, device="meta"):
    return model.init_cache(batch_size, cache_len, dtype, torch.device(device))
