"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the
counterpart of ``repro/models/mla.py``.

KV is compressed to ``kv_lora_rank`` latents plus one shared decoupled-RoPE
key a position; the decode cache holds only ``(c_kv, k_rope)`` a token (512
+ 64 numbers at the full config, against 128·(128 + 128) for a 128-head
GQA cache of the same dims).

* Training decompresses K and V (``k_up``, ``v_up``) and runs the port's
  autograd :func:`~repro_torch.models.attention.flash_attention` on q, k of
  ``qk_nope + qk_rope`` (192) and v of ``v_head_dim`` (128).
* Prefill (a cache given) decompresses likewise and runs the flash
  attention kernel (``swa_attention``, B8, causal, no window). B8 takes one
  head dim for q, k and v, as the TPU kernel does, so v is zero-padded to
  q's and the output cut back: exact, the padded columns are P·0. The scale
  stays ``(qk_nope + qk_rope)^-½``, the reference's. The cache keeps the
  last ``length`` positions, padded with ``pos`` −1.
* Decode absorbs the up-projections (plain PyTorch products, as the
  reference computes them in jnp): q_lat = q_nope·W_ukᵀ, scores c_kv·q_lat
  + k_rope·q_rope in f32, the softmax in f32, p rounded to the cache's
  dtype, ctx_lat = p·c_kv, out = ctx_lat·W_uv. It reads the raw ``k_up`` /
  ``v_up`` kernels and never their adapters, as the reference does (train
  and prefill do apply them): with adapters on k_up or v_up the decode step
  parts from the teacher-forced forward.

With a cache (serving) every adapted projection runs
:func:`~repro_torch.models.common.project` fused: the B3 kernel on the
card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_swa import swa_attention
from repro_torch.models.attention import (NEG_INF, _prefill_cache,
                                          flash_attention)
from repro_torch.models.common import (Params, apply_norm, apply_rope,
                                       make_dense_params, make_norm_params,
                                       maybe_lora, project)
from repro_torch.util.device import resolve_device


def make_mla_params(gen, cfg, dtype, device, lead=()) -> Params:
    """The reference's MLA leaves, stacked on the ``lead`` axes: the query
    path d → q_lora_rank → heads × (nope + rope), the KV path d →
    kv_lora_rank + rope and kv_lora_rank → heads × nope (K) and heads × v
    (V), and o_proj; q_norm and kv_norm are RMSNorm scales."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    kvr, qr = cfg.kv_lora_rank, cfg.q_lora_rank

    def dense(d_in, d_out):
        return make_dense_params(gen, (*lead, d_in, d_out), dtype, device)

    return {
        "q_down": dense(d, qr),
        "q_norm": make_norm_params("rmsnorm", (*lead, qr), dtype, device),
        "q_up": dense(qr, h * (nope + rope)),
        "kv_down": dense(d, kvr + rope),
        "kv_norm": make_norm_params("rmsnorm", (*lead, kvr), dtype, device),
        "k_up": dense(kvr, h * nope),
        "v_up": dense(kvr, h * dv),
        "o_proj": dense(h * dv, d),
    }


def _proj(params, lora, lora_scale, fused, x, name):
    return project(x, params[name], maybe_lora(lora, name), lora_scale, fused)


def _project_q(cfg, params, x, lora, lora_scale, fused):
    """x (B, S, d) → q_nope (B, S, H, nope), q_rope (B, S, H, rope)."""
    b, s, _ = x.shape
    nope = cfg.qk_nope_head_dim
    qd = _proj(params, lora, lora_scale, fused, x, "q_down")
    qd = apply_norm("rmsnorm", params["q_norm"], qd)
    q = _proj(params, lora, lora_scale, fused, qd, "q_up")
    q = q.reshape(b, s, cfg.num_heads, nope + cfg.qk_rope_head_dim)
    return q[..., :nope], q[..., nope:]


def _project_kv_latent(cfg, params, x, lora, lora_scale, fused):
    """x (B, S, d) → c_kv (B, S, kvr) after RMSNorm, k_rope (B, S, rope):
    one shared rope key a position, before RoPE."""
    kvr = cfg.kv_lora_rank
    kv = _proj(params, lora, lora_scale, fused, x, "kv_down")
    c_kv = apply_norm("rmsnorm", params["kv_norm"], kv[..., :kvr])
    return c_kv, kv[..., kvr:]


def init_mla_cache(batch: int, length: int, cfg, dtype=torch.bfloat16,
                   device="cuda") -> Params:
    """Zero ``c_kv`` (batch, length, kv_lora_rank) and ``k_rope`` (batch,
    length, qk_rope_head_dim), ``pos`` (length,) int32 = −1 (empty)."""
    dev = resolve_device(device)
    return {
        "c_kv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros((batch, length, cfg.qk_rope_head_dim),
                              dtype=dtype, device=dev),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=dev),
    }


def _absorbed_decode(cfg, params, cache, q_nope, q_rope, c_kv, k_rope,
                     position: int) -> torch.Tensor:
    """Write the step at slot ``position % length``, then attend against
    the compressed cache with W_uk absorbed into the query and W_uv applied
    to the latent context, with the reference's casts (:112–136) →
    (B, 1, H, dv)."""
    h, nope = cfg.num_heads, cfg.qk_nope_head_dim
    kvr, dv = cfg.kv_lora_rank, cfg.v_head_dim
    slot = position % cache["c_kv"].shape[1]
    ckv, kr, pos = cache["c_kv"], cache["k_rope"], cache["pos"]
    ckv[:, slot] = c_kv[:, 0].to(ckv.dtype)
    kr[:, slot] = k_rope[:, 0].to(kr.dtype)
    pos[slot] = position
    w_uk = params["k_up"]["kernel"].reshape(kvr, h, nope)
    w_uv = params["v_up"]["kernel"].reshape(kvr, h, dv)
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk.to(q_nope.dtype))
    scale = (nope + cfg.qk_rope_head_dim) ** -0.5
    s_nope = torch.einsum("bqhc,bsc->bhqs", q_lat.float(), ckv.float())
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr.float())
    scores = (s_nope + s_rope) * scale
    valid = (pos >= 0) & (pos <= position)
    scores = scores.masked_fill(~valid[None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhqs,bsc->bqhc", w.to(ckv.dtype), ckv)
    dt = torch.promote_types(ctx_lat.dtype, w_uv.dtype)
    return torch.einsum("bqhc,chd->bqhd", ctx_lat.to(dt), w_uv.to(dt))


def mla_block(cfg, params: Params, x: torch.Tensor, *,
              lora: Optional[Params] = None, lora_scale: float = 0.0,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None,
              decode_position: Optional[Union[int, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA over ``x (B, S, d_model)``, causal; returns ``(output, cache)``
    as the reference does. Training: ``cache=None``. Serving: prefill
    (``cache`` given) fills the cache in place and runs B8; decode
    (``decode_position`` given, S = 1) writes the step at ``position %
    length`` and attends absorbed. Serving's adapted projections run
    B3."""
    b, s, _ = x.shape
    h, dv = cfg.num_heads, cfg.v_head_dim
    serving = cache is not None
    if decode_position is not None and not serving:
        raise ValueError("mla_block: decode needs a cache")
    if decode_position is not None:
        # torch.full, not torch.tensor: no blocking host-to-device copy
        positions = torch.full((1,), int(decode_position), device=x.device)
    elif positions is None:
        positions = torch.arange(s, device=x.device)

    q_nope, q_rope = _project_q(cfg, params, x, lora, lora_scale, serving)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _project_kv_latent(cfg, params, x, lora, lora_scale,
                                      serving)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]

    if decode_position is not None:
        out = _absorbed_decode(cfg, params, cache, q_nope, q_rope, c_kv,
                               k_rope, int(decode_position))
    else:
        def up(name, width):
            y = _proj(params, lora, lora_scale, serving, c_kv, name)
            return y.reshape(b, s, h, width)

        k_nope = up("k_up", cfg.qk_nope_head_dim)
        v = up("v_up", dv)
        k_rope_b = k_rope[:, :, None, :].expand(b, s, h,
                                                cfg.qk_rope_head_dim)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_b], dim=-1)
        if serving:
            dk = q_full.shape[-1]
            out = swa_attention(q_full, k_full, F.pad(v, (0, dk - dv)),
                                causal=True, window=0)[..., :dv]
            # the reference's :147–158
            _prefill_cache(cache, positions, c_kv=c_kv, k_rope=k_rope)
        else:
            out = flash_attention(q_full, k_full, v)

    out = out.reshape(b, s, h * dv).to(x.dtype)
    out = _proj(params, lora, lora_scale, serving, out, "o_proj")
    return out.to(x.dtype), cache
