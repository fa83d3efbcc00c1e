"""Decoder-only stack, dense, vlm, MoE, hybrid and ssm (xLSTM) families:
``make_params``, ``init_cache`` and ``forward`` (train, prefill and
decode).

Counterpart of the dense, vlm, MoE, hybrid and ssm branches of
``repro/models/transformer.py``. The parameter layout is the reference's: every per-layer leaf is stacked on a
leading layer axis (``layers/attn/q_proj/kernel`` is ``(L, d, h·hd)``), so a
flattened port tree lines up one-to-one with the reference's. A config with
``local_global_ratio`` (gemma3) stacks its layers by period instead:
``periods/local/…`` is ``(nper, ratio, …)`` and ``periods/global/…``
``(nper, …)``, nper = L // (ratio + 1); each period runs its ``ratio`` local
layers at ``local_window``, then its global layer. ``sliding_window``
windows every layer of the plain stack. Windowed layers keep ring caches of
``min(window, cache_len)`` slots. A MoE config (``family="moe"``) stacks
its MoE layers under ``layers`` (each MLP a router and raw expert stacks,
:mod:`repro_torch.models.moe`) behind ``first_k_dense`` dense layers under
``dense_layers`` (MLP width ``dense_d_ff``); its router aux losses sum
over the layers. A config with ``mla`` (deepseek-v2) runs every layer's
attention as Multi-head Latent Attention (:mod:`repro_torch.models.mla`),
whose caches hold the compressed latents. A hybrid config (zamba2)
stacks its Mamba2 layers (:mod:`repro_torch.models.ssm`) by period under
``mamba_layers`` (``(nper, attn_every, …)``, nper = L // attn_every) and
the rest under ``mamba_trailing``; each period runs its Mamba2 layers,
then ONE parameter-shared attention + MLP layer, ``shared_attn`` (no layer
axis), with its one adapter and that period's KV cache. An ssm config
(xlstm) stacks its blocks by period under ``periods``: ``periods/mlstm/…``
is ``(nper, slstm_every − 1, …)`` and ``periods/slstm/…`` ``(nper, …)``,
nper = L // slstm_every; each period runs its mLSTM blocks, then its
sLSTM block (:mod:`repro_torch.models.xlstm`). A vlm config (internvl2)
is the dense stack plus ``vision_proj``, a d × d dense without an
adapter: in train and prefill :func:`forward` projects the given patch
embeddings (``extra_embeds``, the stubbed ViT's) through it and prepends
them to the token embeddings, so positions run over the concatenated
length; decode reads tokens only. Where JAX scans
the stacked parameters, the port runs a Python loop over the layer (and
period) index. The reference's ``remat`` has no counterpart: at the batch
sizes the port trains, activations fit without recomputation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (attention_block, init_kv_cache,
                                          make_attention_params)
from repro_torch.models.common import (Params, apply_norm, dense, dtype_of,
                                       embed, make_dense_params,
                                       make_norm_params, normal_init, unembed)
from repro_torch.models.mla import init_mla_cache, make_mla_params, mla_block
from repro_torch.models.mlp import make_mlp_params, mlp_block
from repro_torch.models.moe import make_moe_params, moe_block
from repro_torch.models.ssm import (init_mamba_cache, make_mamba2_params,
                                    mamba2_block)
from repro_torch.models.xlstm import (init_mlstm_cache, init_slstm_cache,
                                      make_mlstm_params, make_slstm_params,
                                      mlstm_block, slstm_block)

MODES = ("train", "prefill", "decode")
FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` asks only for the
    branches the port runs: the dense decoder — RoPE or learned positions,
    RMSNorm or LayerNorm, gated SiLU or plain GELU MLP, with or without
    q/k/v (and, under LayerNorm, MLP) biases, tied or untied unembedding,
    global attention, a sliding window on every layer, or periods of local
    (windowed) and global layers — and its MoE counterpart (top-k routed
    experts, shared experts, leading dense layers), either with Multi-head
    Latent Attention (``mla``) — the hybrid stack (Mamba2 layers with
    one parameter-shared attention + MLP layer every ``attn_every`` of
    them), the ssm stack (xLSTM: periods of ``slstm_every − 1`` mLSTM
    blocks and one sLSTM block), the encoder-decoder (whisper,
    :mod:`repro_torch.models.encdec`) and the vision-language decoder
    (internvl2: the dense stack behind a projected patch prefix). As in
    the reference, the family decides: a dense config with
    ``num_experts`` builds dense MLPs."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"config {cfg.name!r} asks for family {cfg.family!r}: the port "
            f"runs the families {', '.join(FAMILIES)}")


def _decoder_only(cfg, what: str) -> None:
    """:func:`check_supported`, and refuse the encdec family by name: its
    stacks, caches and forward are :mod:`repro_torch.models.encdec`'s (the
    reference's ``transformer.py`` refuses it alike)."""
    check_supported(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"transformer.{what}: config {cfg.name!r} is of family 'encdec', "
            "which has its own (repro_torch.models.encdec)")


def _periods(cfg):
    """(periods, local layers a period) of a local/global config."""
    ratio = cfg.local_global_ratio
    return cfg.num_layers // (ratio + 1), ratio


def hybrid_layout(cfg):
    """(periods, trailing Mamba2 layers) of a hybrid config."""
    nper = cfg.num_layers // cfg.attn_every
    return nper, cfg.num_layers - nper * cfg.attn_every


def xlstm_layout(cfg):
    """(periods, blocks a period) of an ssm config: each period is
    ``slstm_every − 1`` mLSTM blocks and one sLSTM block."""
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every


def _mamba_layer_params(gen, cfg, lead, dtype, device) -> Params:
    """One Mamba2 layer's leaves (its pre-norm and block), stacked on the
    ``lead`` axes."""
    return {"norm": make_norm_params(cfg.norm, (*lead, cfg.d_model), dtype,
                                     device),
            "mamba": make_mamba2_params(gen, cfg, dtype, device, lead)}


def _layer_params(gen, cfg, lead, dtype, device, *, moe: bool = False,
                  d_ff: int = 0) -> Params:
    """One decoder layer's leaves, stacked on the ``lead`` axes: MLA's
    attention with ``cfg.mla``, else q/k/v/o; a MoE MLP with ``moe``, else a
    dense one of width ``d_ff`` (0: ``cfg.d_ff``)."""
    d = cfg.d_model
    return {
        "attn_norm": make_norm_params(cfg.norm, (*lead, d), dtype, device),
        "mlp_norm": make_norm_params(cfg.norm, (*lead, d), dtype, device),
        "attn": make_mla_params(gen, cfg, dtype, device, lead) if cfg.mla
        else make_attention_params(gen, cfg, lead, dtype, device),
        "mlp": (make_moe_params(gen, cfg, dtype, device, lead) if moe
                else make_mlp_params(gen, cfg, dtype, device, lead=lead,
                                     d_ff=d_ff)),
    }


def make_params(gen: torch.Generator, cfg, device) -> Params:
    """The port's own draws (N(0, 0.02) kernels and embeddings, unit norm
    scales, zero biases), in the reference's stacked layout."""
    _decoder_only(cfg, "make_params")
    dtype = dtype_of(cfg)
    d = cfg.d_model
    params: Params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, d), dtype,
                                           device)},
    }
    if cfg.learned_pos_embeddings:
        params["pos_embed"] = {"embedding": normal_init(
            gen, (cfg.max_position_embeddings, d), dtype, device)}
    if cfg.family == "moe":
        if cfg.first_k_dense:
            params["dense_layers"] = _layer_params(
                gen, cfg, (cfg.first_k_dense,), dtype, device,
                d_ff=cfg.dense_d_ff)
        params["layers"] = _layer_params(
            gen, cfg, (cfg.num_layers - cfg.first_k_dense,), dtype, device,
            moe=True)
    elif cfg.family == "hybrid":
        nper, trailing = hybrid_layout(cfg)
        params["mamba_layers"] = _mamba_layer_params(
            gen, cfg, (nper, cfg.attn_every), dtype, device)
        if trailing:
            params["mamba_trailing"] = _mamba_layer_params(
                gen, cfg, (trailing,), dtype, device)
        params["shared_attn"] = _layer_params(gen, cfg, (), dtype, device)
    elif cfg.family == "ssm":
        nper, period = xlstm_layout(cfg)
        params["periods"] = {
            "mlstm": make_mlstm_params(gen, cfg, dtype, device,
                                       (nper, period - 1)),
            "slstm": make_slstm_params(gen, cfg, dtype, device, (nper,)),
        }
    elif cfg.local_global_ratio:
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
    if cfg.family == "vlm":  # the stubbed ViT's projector, no adapter
        params["vision_proj"] = make_dense_params(gen, (d, d), dtype, device)
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
    layer's ``cache_len``. A MoE config's cache is ``{"layers": …}`` over
    its MoE layers, with ``{"dense_layers": …}`` over its leading dense
    ones. An MLA config's layers hold ``{"c_kv": (L, batch, length,
    kv_lora_rank), "k_rope": (L, batch, length, qk_rope_head_dim), "pos"}``
    instead of k and v. A hybrid config's is ``{"mamba": {"ssm": (nper,
    attn_every, batch, H, P, N) f32, "conv": (nper, attn_every, batch,
    K − 1, conv_ch)}, "shared_attn": …(nper, …)}`` (one KV cache a period
    for the shared layer), with ``{"mamba_trailing": …}`` over its
    trailing Mamba2 layers. An ssm config's is ``{"mlstm": {"C": (nper,
    slstm_every − 1, batch, H, Dh, Dh), "n", "m" f32, "conv": (…, batch,
    3, d_inner)}, "slstm": {"c", "n", "m" f32, "h": (nper, batch, d)}}``
    (no KV cache: ``cache_len`` plays no part). A vlm config's is the
    dense one; its ``cache_len`` counts the vision prefix too."""
    _decoder_only(cfg, "init_cache")

    def expand(one, lead):
        return {k: v.expand(*lead, *v.shape).clone() for k, v in one.items()}

    def stacked(lead, window):
        length = min(window, cache_len) if window else cache_len
        if cfg.mla:
            one = init_mla_cache(batch, length, cfg, dtype, device)
        else:
            one = init_kv_cache(batch, length, cfg.num_kv_heads,
                                cfg.resolved_head_dim, dtype, device)
        return expand(one, lead)

    if cfg.family == "ssm":
        nper, period = xlstm_layout(cfg)
        return {"mlstm": expand(init_mlstm_cache(batch, cfg, dtype, device),
                                (nper, period - 1)),
                "slstm": expand(init_slstm_cache(batch, cfg, dtype, device),
                                (nper,))}
    if cfg.family == "hybrid":
        nper, trailing = hybrid_layout(cfg)
        one = init_mamba_cache(batch, cfg, dtype, device)
        out = {"mamba": expand(one, (nper, cfg.attn_every)),
               "shared_attn": stacked((nper,), 0)}
        if trailing:
            out["mamba_trailing"] = expand(one, (trailing,))
        return out

    if cfg.local_global_ratio:
        nper, ratio = _periods(cfg)
        return {"local": stacked((nper, ratio), cfg.local_window),
                "global": stacked((nper,), 0)}
    if cfg.family == "moe" and cfg.first_k_dense:
        return {"layers": stacked((cfg.num_layers - cfg.first_k_dense,),
                                  cfg.sliding_window),
                "dense_layers": stacked((cfg.first_k_dense,),
                                        cfg.sliding_window)}
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


def decoder_layer(cfg, p: Params, x: torch.Tensor, *,
                  lora: Optional[Params], lora_scale: float, positions,
                  window: int, cache: Optional[Params], position,
                  moe_impl: str = "ragged", lanes: Optional[int] = None):
    """One pre-norm layer (the reference's ``_attn_mlp_layer``) of its own
    leaves ``p``, adapter ``lora`` and cache → ``(x, aux)``: attention,
    then the dense MLP (aux None) or the MoE block (its router's aux loss;
    with mesh mode's ``lanes``, each lane's, (lanes,)). An MLA config's
    attention is :func:`~repro_torch.models.mla.mla_block`. With a cache
    (serving) the adapted projections run the fused LoRA kernel."""
    lora = lora or {}
    fused = cache is not None
    h_in = apply_norm(cfg.norm, p["attn_norm"], x)
    if cfg.mla:
        attn, _ = mla_block(cfg, p["attn"], h_in, lora=lora.get("attn"),
                            lora_scale=lora_scale, positions=positions,
                            cache=cache, decode_position=position)
    else:
        attn, _ = attention_block(cfg, p["attn"], h_in,
                                  lora=lora.get("attn"),
                                  lora_scale=lora_scale, positions=positions,
                                  window=window, cache=cache,
                                  decode_position=position)
    x = x + attn
    m_in = apply_norm(cfg.norm, p["mlp_norm"], x)
    if "router" in p["mlp"]:
        m, aux = moe_block(cfg, p["mlp"], m_in, lora=lora.get("mlp"),
                           lora_scale=lora_scale, impl=moe_impl, fused=fused,
                           lanes=lanes)
    else:
        m = mlp_block(cfg, p["mlp"], m_in, lora=lora.get("mlp"),
                      lora_scale=lora_scale, fused=fused)
        aux = None
    return x + m, aux


def forward(cfg, params: Params, tokens: torch.Tensor, *,
            lora: Optional[Params] = None, lora_scale: float = 0.0,
            mode: str = "train", cache: Optional[Params] = None,
            position=None, moe_impl: str = "ragged",
            with_aux: bool = False,
            extra_embeds: Optional[torch.Tensor] = None,
            lanes: Optional[int] = None):
    """tokens (B, S) int → logits (B, S, V) f32.

    A vlm config's ``extra_embeds`` (B, Vt, d), in train and prefill, are
    cast to the activations' dtype, projected by ``vision_proj`` and
    prepended to the token embeddings, as the reference's: the logits are
    then (B, Vt + S, V) and the prefill fills Vt + S cache positions.
    Decode, and any other family, ignore them.

    ``mode="train"`` returns the logits, or with ``with_aux`` ``(logits,
    aux)``: the router aux losses summed over the layers (f32 0 for a dense
    config). ``"prefill"`` (prompt tokens, a cache from :func:`init_cache`)
    and ``"decode"`` (one token a row, its absolute ``position``) return
    ``(logits, cache)``; they run forward only, through the serving kernels,
    and update the cache in place (a hybrid or ssm cache's conv buffers
    first widened to the activations' dtype where that is wider, as the
    reference's conv state comes back in it; an sLSTM's ``h`` keeps the
    cache's dtype). ``moe_impl`` picks the MoE
    block's path (``"ragged"`` or the ``"dense"`` oracle).

    ``lanes`` (mesh mode, train): the batch is that many blocks of rows,
    lane-major, under lane-stacked adapters; a MoE config's aux is then
    (lanes,), each lane's router aux losses summed over the layers.
    """
    _decoder_only(cfg, "forward")
    if mode not in MODES:
        raise ValueError(f"forward: mode {mode!r} not in {MODES}")
    if (mode == "train") != (cache is None):
        raise ValueError(f"forward: mode {mode!r} "
                         f"{'takes no' if mode == 'train' else 'needs a'} "
                         "cache")
    if (mode == "decode") != (position is not None):
        raise ValueError("forward: a decode position goes with mode='decode' "
                         "only")
    if with_aux and mode != "train":
        raise ValueError("forward: with_aux goes with mode='train' only")
    x = embed(params["embed"], tokens)
    if (cfg.family == "vlm" and extra_embeds is not None
            and mode != "decode"):
        vis = dense(extra_embeds.to(x.dtype), params["vision_proj"])
        x = torch.cat([vis, x], dim=1)
    positions = (None if mode == "decode"
                 else torch.arange(x.shape[1], device=tokens.device))
    if cfg.learned_pos_embeddings:
        x = x + _learned_positions(cfg, params["pos_embed"]["embedding"],
                                   x.shape[1], position)
    lora = lora or {}
    aux_total = None

    def layer(x, stack, stack_lora, stack_cache, idx, window):
        """The layer at ``idx`` of a stacked tree, with its adapter and
        cache."""
        nonlocal aux_total
        x, aux = decoder_layer(
            cfg, _layer_slice(stack, *idx), x,
            lora=_layer_slice(stack_lora, *idx), lora_scale=lora_scale,
            positions=positions, window=window,
            cache=_layer_slice(stack_cache, *idx), position=position,
            moe_impl=moe_impl, lanes=lanes)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        return x

    def part(tree, key):
        return None if tree is None else tree.get(key)

    def mamba(x, stack, stack_lora, stack_cache, idx):
        """The Mamba2 layer at ``idx`` of a stacked tree (the reference's
        ``_mamba_layer``)."""
        p = _layer_slice(stack, *idx)
        h, _ = mamba2_block(
            cfg, p["mamba"], apply_norm(cfg.norm, p["norm"], x),
            lora=part(_layer_slice(stack_lora, *idx), "mamba"),
            lora_scale=lora_scale, cache=_layer_slice(stack_cache, *idx),
            decode=mode == "decode")
        return x + h

    if cache is not None:
        for sub in cache.values():
            if "conv" in sub:
                sub["conv"] = sub["conv"].to(
                    torch.promote_types(sub["conv"].dtype, x.dtype))
    if cfg.family == "ssm":  # the reference's xperiod_body, unrolled
        nper, period = xlstm_layout(cfg)
        per, per_lora = params["periods"], lora.get("periods")
        for i in range(nper):
            for j in range(period - 1):
                x, _ = mlstm_block(
                    cfg, _layer_slice(per["mlstm"], i, j), x,
                    lora=_layer_slice(part(per_lora, "mlstm"), i, j),
                    lora_scale=lora_scale,
                    cache=_layer_slice(part(cache, "mlstm"), i, j),
                    decode=mode == "decode")
            x, _ = slstm_block(
                cfg, _layer_slice(per["slstm"], i), x,
                lora=_layer_slice(part(per_lora, "slstm"), i),
                lora_scale=lora_scale,
                cache=_layer_slice(part(cache, "slstm"), i),
                decode=mode == "decode")
    elif cfg.family == "hybrid":  # the reference's hperiod_body, unrolled
        nper, trailing = hybrid_layout(cfg)
        for i in range(nper):
            for j in range(cfg.attn_every):
                x = mamba(x, params["mamba_layers"],
                          lora.get("mamba_layers"), part(cache, "mamba"),
                          (i, j))
            x, _ = decoder_layer(
                cfg, params["shared_attn"], x, lora=lora.get("shared_attn"),
                lora_scale=lora_scale, positions=positions, window=0,
                cache=_layer_slice(part(cache, "shared_attn"), i),
                position=position)
        for i in range(trailing):
            x = mamba(x, params["mamba_trailing"], lora.get("mamba_trailing"),
                      part(cache, "mamba_trailing"), (i,))
    elif cfg.local_global_ratio:  # the reference's period_body, unrolled
        nper, ratio = _periods(cfg)
        per, per_lora = params["periods"], lora.get("periods")
        for i in range(nper):
            for j in range(ratio):
                x = layer(x, per["local"], part(per_lora, "local"),
                          part(cache, "local"), (i, j), cfg.local_window)
            x = layer(x, per["global"], part(per_lora, "global"),
                      part(cache, "global"), (i,), 0)
    else:
        stacks = (["dense_layers"] if "dense_layers" in params else []
                  ) + ["layers"]
        for key in stacks:
            for i in range(params[key]["attn_norm"]["scale"].shape[0]):
                x = layer(x, params[key], lora.get(key), part(cache, key),
                          (i,), cfg.sliding_window)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    tied = params["embed"]["embedding"] if cfg.tie_embeddings else None
    logits = unembed(params.get("lm_head", {}), x, tied_embedding=tied,
                     lora=lora.get("lm_head"), lora_scale=lora_scale)
    if cache is not None:
        return logits, cache
    if not with_aux:
        return logits
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux_total
