"""Encoder-decoder stack (whisper-style): ``make_params``, ``encode``,
``init_cache`` and ``decoder_forward`` (train, prefill and decode).

Counterpart of ``repro/models/encdec.py``. The mel/conv audio frontend is a
stub, as in the reference: the encoder reads precomputed frame embeddings
``frames (B, enc_seq_len, d_model)``. The encoder is ``enc_layers``
pre-norm layers of bidirectional (non-causal) attention and the MLP over
the frames plus a learned position table of ``enc_seq_len`` rows; the
decoder is ``num_layers`` layers of causal self-attention, cross-attention
to the encoder's output and the MLP, over the tokens plus the learned
position table of ``max_position_embeddings`` rows. Serving keeps two
caches a decoder layer: ``self`` (``cache_len`` slots, written at each
step) and ``cross`` (``enc_seq_len`` slots, filled once at prefill and
only read at decode, so a decode step needs no frames). The parameter
layout is the reference's (every per-layer leaf stacked on a leading
layer axis: ``encoder/attn/q_proj/kernel`` is ``(enc_layers, d, h·hd)``,
``decoder/cross_attn/q_proj/kernel`` ``(num_layers, d, h·hd)``); where JAX
scans the stacks, the port runs a Python loop over the layer index. In
serving (prefill, and the encoder's pass before it) the adapted
projections run the fused LoRA kernel (B3) and every attention of the
prefill the flash attention kernel (B8); decode attends against the caches
with :func:`~repro_torch.models.attention.decode_attention`. The
reference's ``remat`` has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.util.cost import Loop
from repro_torch.models.attention import (attention_block, init_kv_cache,
                                          make_attention_params)
from repro_torch.models.common import (Params, apply_norm, dtype_of, embed,
                                       make_norm_params, normal_init, unembed)
from repro_torch.models.mlp import make_mlp_params, mlp_block
from repro_torch.models.transformer import (MODES, _layer_params,
                                            _layer_slice, _learned_positions)


def _check(cfg, what: str) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"encdec.{what}: config {cfg.name!r} is of family "
                         f"{cfg.family!r}, not 'encdec'")


def make_params(gen: torch.Generator, cfg, device) -> Params:
    """The port's own draws (N(0, 0.02) kernels and embeddings, unit norm
    scales, zero biases) in the reference's layout: ``embed``,
    ``pos_embed``, ``enc_pos_embed``, the ``encoder`` stack (``attn_norm``,
    ``attn``, ``mlp_norm``, ``mlp``), ``enc_final_norm``, the ``decoder``
    stack (``self_norm``, ``self_attn``, ``cross_norm``, ``cross_attn``,
    ``mlp_norm``, ``mlp``), ``final_norm``, and ``lm_head`` only when the
    embedding is not tied."""
    _check(cfg, "make_params")
    dtype, d = dtype_of(cfg), cfg.d_model
    lead = (cfg.num_layers,)

    def norm(shape):
        return make_norm_params(cfg.norm, shape, dtype, device)

    params: Params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, d), dtype,
                                           device)},
        "pos_embed": {"embedding": normal_init(
            gen, (cfg.max_position_embeddings, d), dtype, device)},
        "enc_pos_embed": {"embedding": normal_init(
            gen, (cfg.enc_seq_len, d), dtype, device)},
        "encoder": _layer_params(gen, cfg, (cfg.enc_layers,), dtype, device),
        "enc_final_norm": norm((d,)),
        "decoder": {
            "self_norm": norm((*lead, d)),
            "self_attn": make_attention_params(gen, cfg, lead, dtype,
                                               device),
            "cross_norm": norm((*lead, d)),
            "cross_attn": make_attention_params(gen, cfg, lead, dtype,
                                                device),
            "mlp_norm": norm((*lead, d)),
            "mlp": make_mlp_params(gen, cfg, dtype, device, lead=lead),
        },
        "final_norm": norm((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal_init(
            gen, (d, cfg.vocab_size), dtype, device)}
    return params


def encode(cfg, params: Params, frames: torch.Tensor, *,
           lora: Optional[Params] = None, lora_scale: float = 0.0,
           fused: bool = False) -> torch.Tensor:
    """frames (B, S, d_model), S ≤ ``enc_seq_len``, cast to the config's
    dtype, plus ``enc_pos_embed[:S]``, through the encoder's pre-norm
    layers of non-causal attention and the MLP, then ``enc_final_norm``
    → (B, S, d_model). ``fused`` (serving) runs the adapted projections
    through the fused LoRA kernel and the attention through the flash
    attention kernel."""
    lora = lora or {}
    x = frames.to(dtype_of(cfg))
    x = x + params["enc_pos_embed"]["embedding"][:x.shape[1]]
    stack, stack_lora = params["encoder"], lora.get("encoder")
    for i in Loop(cfg.enc_layers, x.device):
        p = _layer_slice(stack, i)
        lo = _layer_slice(stack_lora, i) or {}
        h, _ = attention_block(cfg, p["attn"],
                               apply_norm(cfg.norm, p["attn_norm"], x),
                               lora=lo.get("attn"), lora_scale=lora_scale,
                               causal=False, fused=fused)
        x = x + h
        x = x + mlp_block(cfg, p["mlp"],
                          apply_norm(cfg.norm, p["mlp_norm"], x),
                          lora=lo.get("mlp"), lora_scale=lora_scale,
                          fused=fused)
    return apply_norm(cfg.norm, params["enc_final_norm"], x)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> Params:
    """``{"self": {"k", "v": (L, batch, cache_len, KVH, hd), "pos": (L,
    cache_len)}, "cross": {"k", "v": (L, batch, enc_seq_len, KVH, hd),
    "pos": (L, enc_seq_len)}}``, zero buffers in ``dtype`` and pos −1 (the
    reference's)."""
    _check(cfg, "init_cache")
    lead, hd = (cfg.num_layers,), cfg.resolved_head_dim

    def stacked(length):
        one = init_kv_cache(batch, length, cfg.num_kv_heads, hd, dtype,
                            device)
        return {k: v.expand(*lead, *v.shape).clone() for k, v in one.items()}

    return {"self": stacked(cache_len), "cross": stacked(cfg.enc_seq_len)}


def decoder_forward(cfg, params: Params, tokens: torch.Tensor,
                    enc_out: Optional[torch.Tensor], *,
                    lora: Optional[Params] = None, lora_scale: float = 0.0,
                    mode: str = "train", cache: Optional[Params] = None,
                    position=None):
    """tokens (B, S) int, the encoder's output (B, S_enc, d_model) → logits
    (B, S, V) f32, and with a cache ``(logits, cache)``.

    ``mode="train"``: no cache. ``"prefill"``: a cache from
    :func:`init_cache`, filled in place (the self cache with the prompt,
    the cross cache with k and v of ``enc_out``). ``"decode"``: one token
    a row at its absolute ``position`` (its learned position row clamped
    at ``max_position_embeddings − 1``, as the reference's), ``enc_out``
    None: the cross-attention reads the cross cache. Each layer:
    self-attention, cross-attention, the MLP, each pre-norm."""
    if mode not in MODES:
        raise ValueError(f"decoder_forward: mode {mode!r} not in {MODES}")
    if (mode == "train") != (cache is None):
        raise ValueError(f"decoder_forward: mode {mode!r} "
                         f"{'takes no' if mode == 'train' else 'needs a'} "
                         "cache")
    if (mode == "decode") != (position is not None):
        raise ValueError("decoder_forward: a decode position goes with "
                         "mode='decode' only")
    if (mode == "decode") != (enc_out is None):
        raise ValueError("decoder_forward: decode reads the cross cache "
                         "(enc_out None); train and prefill need enc_out")
    lora = lora or {}
    x = embed(params["embed"], tokens)
    x = x + _learned_positions(cfg, params["pos_embed"]["embedding"],
                               tokens.shape[1], position)
    positions = (None if mode == "decode"
                 else torch.arange(tokens.shape[1], device=tokens.device))
    fused = cache is not None
    stack, stack_lora = params["decoder"], lora.get("decoder")
    for i in Loop(cfg.num_layers, x.device):
        p = _layer_slice(stack, i)
        lo = _layer_slice(stack_lora, i) or {}
        ca = _layer_slice(cache, i) or {}
        h, _ = attention_block(cfg, p["self_attn"],
                               apply_norm(cfg.norm, p["self_norm"], x),
                               lora=lo.get("self_attn"),
                               lora_scale=lora_scale, positions=positions,
                               cache=ca.get("self"), decode_position=position)
        x = x + h
        h, _ = attention_block(cfg, p["cross_attn"],
                               apply_norm(cfg.norm, p["cross_norm"], x),
                               lora=lo.get("cross_attn"),
                               lora_scale=lora_scale, kv_x=enc_out,
                               cross=True, causal=False,
                               cache=ca.get("cross"), decode_position=position)
        x = x + h
        x = x + mlp_block(cfg, p["mlp"],
                          apply_norm(cfg.norm, p["mlp_norm"], x),
                          lora=lo.get("mlp"), lora_scale=lora_scale,
                          fused=fused)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    tied = params["embed"]["embedding"] if cfg.tie_embeddings else None
    logits = unembed(params.get("lm_head", {}), x, tied_embedding=tied)
    if cache is not None:
        return logits, cache
    return logits
