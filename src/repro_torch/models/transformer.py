"""Decoder-only stack, dense family: ``make_params``, ``init_cache`` and
``forward`` (train, prefill and decode).

Counterpart of the dense branch of ``repro/models/transformer.py``. The
parameter layout is the reference's: every per-layer leaf is stacked on a
leading layer axis (``layers/attn/q_proj/kernel`` is ``(L, d, h·hd)``), so a
flattened port tree lines up one-to-one with the reference's. A config with
``local_global_ratio`` (gemma3) stacks its layers by period instead:
``periods/local/…`` is ``(nper, ratio, …)`` and ``periods/global/…``
``(nper, …)``, nper = L // (ratio + 1); each period runs its ``ratio`` local
layers at ``local_window``, then its global layer. ``sliding_window``
windows every layer of the plain stack. Windowed layers keep ring caches of
``min(window, cache_len)`` slots. Where JAX scans the stacked parameters,
the port runs a Python loop over the layer (and period) index. The
reference's ``remat`` has no counterpart: at the batch sizes the port
trains, activations fit without recomputation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import attention_block, init_kv_cache
from repro_torch.models.common import (Params, apply_norm, dtype_of, embed,
                                       make_dense_params, make_norm_params,
                                       normal_init, unembed)
from repro_torch.models.mlp import make_mlp_params, mlp_block

MODES = ("train", "prefill", "decode")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` asks only for the branch
    the port runs: the dense decoder — RoPE or learned positions, RMSNorm or
    LayerNorm, gated SiLU or plain GELU MLP, with or without q/k/v (and,
    under LayerNorm, MLP) biases, tied or untied unembedding, global
    attention, a sliding window on every layer, or periods of local
    (windowed) and global layers."""
    unsupported = {
        "family": cfg.family != "dense",
        "mla": cfg.mla,
        "num_experts": bool(cfg.num_experts),
    }
    asked = [k for k, v in unsupported.items() if v]
    if asked:
        raise NotImplementedError(
            f"config {cfg.name!r} asks for {asked}: the port runs only the "
            "dense decoder so far")


def _periods(cfg):
    """(periods, local layers a period) of a local/global config."""
    ratio = cfg.local_global_ratio
    return cfg.num_layers // (ratio + 1), ratio


def _layer_params(gen, cfg, lead, dtype, device) -> Params:
    """One decoder layer's leaves, stacked on the ``lead`` axes."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, bias = cfg.num_heads, cfg.num_kv_heads, cfg.qkv_bias
    return {
        "attn_norm": make_norm_params(cfg.norm, (*lead, d), dtype, device),
        "mlp_norm": make_norm_params(cfg.norm, (*lead, d), dtype, device),
        "attn": {
            "q_proj": make_dense_params(gen, (*lead, d, h * hd), dtype,
                                        device, bias=bias),
            "k_proj": make_dense_params(gen, (*lead, d, kv * hd), dtype,
                                        device, bias=bias),
            "v_proj": make_dense_params(gen, (*lead, d, kv * hd), dtype,
                                        device, bias=bias),
            "o_proj": make_dense_params(gen, (*lead, h * hd, d), dtype,
                                        device),
        },
        "mlp": make_mlp_params(gen, cfg, dtype, device, lead=lead),
    }


def make_params(gen: torch.Generator, cfg, device) -> Params:
    """The port's own draws (N(0, 0.02) kernels and embeddings, unit norm
    scales, zero biases), in the reference's stacked layout."""
    check_supported(cfg)
    dtype = dtype_of(cfg)
    d = cfg.d_model
    params: Params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, d), dtype,
                                           device)},
    }
    if cfg.learned_pos_embeddings:
        params["pos_embed"] = {"embedding": normal_init(
            gen, (cfg.max_position_embeddings, d), dtype, device)}
    if cfg.local_global_ratio:
        nper, ratio = _periods(cfg)
        params["periods"] = {
            "local": _layer_params(gen, cfg, (nper, ratio), dtype, device),
            "global": _layer_params(gen, cfg, (nper,), dtype, device),
        }
    else:
        params["layers"] = _layer_params(gen, cfg, (cfg.num_layers,), dtype,
                                         device)
    params["final_norm"] = make_norm_params(cfg.norm, (d,), dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = make_dense_params(gen, (d, cfg.vocab_size), dtype,
                                              device)
    return params


def _layer_slice(tree, *idx):
    """The layer at index ``idx`` (one index a stacked axis) of a stacked
    tree (views; autograd flows back into the stacked leaves)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer_slice(v, *idx) for k, v in tree.items()}
    return tree[idx]


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> Params:
    """KV cache mirroring the stacked layer layout (the dense branch of the
    reference's ``init_cache``): ``{"layers": {"k", "v": (L, batch, length,
    KVH, hd), "pos": (L, length)}}``, or for a local/global config
    ``{"local": …(nper, ratio, …), "global": …(nper, …)}``. A windowed
    layer's ``length`` is ``min(window, cache_len)`` (a ring), a global
    layer's ``cache_len``."""
    check_supported(cfg)

    def stacked(lead, window):
        length = min(window, cache_len) if window else cache_len
        one = init_kv_cache(batch, length, cfg.num_kv_heads,
                            cfg.resolved_head_dim, dtype, device)
        return {k: v.expand(*lead, *v.shape).clone() for k, v in one.items()}

    if cfg.local_global_ratio:
        nper, ratio = _periods(cfg)
        return {"local": stacked((nper, ratio), cfg.local_window),
                "global": stacked((nper,), 0)}
    return {"layers": stacked((cfg.num_layers,), cfg.sliding_window)}


def _learned_positions(cfg, table: torch.Tensor, seq: int,
                       position) -> torch.Tensor:
    """The rows of the learned position table to add to the embeddings:
    ``table[:seq]`` (train, prefill), or at a decode ``position`` row
    ``min(position, max_position_embeddings − 1)`` (the reference's clamp;
    the cache write and the decode mask keep the position itself)."""
    n = cfg.max_position_embeddings
    if position is not None:
        return table[min(int(position), n - 1)]
    if seq > n:
        raise ValueError(f"a sequence of {seq} tokens exceeds the learned "
                         f"position table: max_position_embeddings={n}")
    return table[:seq]


def forward(cfg, params: Params, tokens: torch.Tensor, *,
            lora: Optional[Params] = None, lora_scale: float = 0.0,
            mode: str = "train", cache: Optional[Params] = None,
            position=None):
    """tokens (B, S) int → logits (B, S, V) f32.

    ``mode="train"`` returns the logits. ``"prefill"`` (prompt tokens, a
    cache from :func:`init_cache`) and ``"decode"`` (one token a row, its
    absolute ``position``) return ``(logits, cache)``; they run forward only,
    through the serving kernels, and update the cache in place.
    """
    check_supported(cfg)
    if mode not in MODES:
        raise ValueError(f"forward: mode {mode!r} not in {MODES}")
    if (mode == "train") != (cache is None):
        raise ValueError(f"forward: mode {mode!r} "
                         f"{'takes no' if mode == 'train' else 'needs a'} "
                         "cache")
    if (mode == "decode") != (position is not None):
        raise ValueError("forward: a decode position goes with mode='decode' "
                         "only")
    x = embed(params["embed"], tokens)
    positions = (None if mode == "decode"
                 else torch.arange(tokens.shape[1], device=tokens.device))
    if cfg.learned_pos_embeddings:
        x = x + _learned_positions(cfg, params["pos_embed"]["embedding"],
                                   tokens.shape[1], position)
    lora = lora or {}

    def layer(x, stack, stack_lora, stack_cache, idx, window):
        """The layer at ``idx`` of a stacked tree, with its adapter and
        cache."""
        p = _layer_slice(stack, *idx)
        lo = _layer_slice(stack_lora, *idx) or {}
        h_in = apply_norm(cfg.norm, p["attn_norm"], x)
        attn, _ = attention_block(cfg, p["attn"], h_in, lora=lo.get("attn"),
                                  lora_scale=lora_scale, positions=positions,
                                  window=window,
                                  cache=_layer_slice(stack_cache, *idx),
                                  decode_position=position)
        x = x + attn
        m_in = apply_norm(cfg.norm, p["mlp_norm"], x)
        return x + mlp_block(cfg, p["mlp"], m_in, lora=lo.get("mlp"),
                             lora_scale=lora_scale, fused=cache is not None)

    def part(tree, key):
        return None if tree is None else tree.get(key)

    if cfg.local_global_ratio:  # the reference's period_body, unrolled
        nper, ratio = _periods(cfg)
        per, per_lora = params["periods"], lora.get("periods")
        for i in range(nper):
            for j in range(ratio):
                x = layer(x, per["local"], part(per_lora, "local"),
                          part(cache, "local"), (i, j), cfg.local_window)
            x = layer(x, per["global"], part(per_lora, "global"),
                      part(cache, "global"), (i,), 0)
    else:
        for i in range(cfg.num_layers):
            x = layer(x, params["layers"], lora.get("layers"),
                      part(cache, "layers"), (i,), cfg.sliding_window)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    tied = params["embed"]["embedding"] if cfg.tie_embeddings else None
    logits = unembed(params.get("lm_head", {}), x, tied_embedding=tied,
                     lora=lora.get("lm_head"), lora_scale=lora_scale)
    return logits if cache is None else (logits, cache)
