"""Attention: GQA with RoPE, blockwise flash attention with its own backward,
and the KV cache of serving; self- and cross-attention.

Counterpart of ``repro/models/attention.py``. The
reference's ``flash_attention`` is a jnp ``custom_vjp`` (not a Pallas kernel):
a scan over KV blocks with an online-softmax carry forward, and a backward
that recomputes the probabilities per block from (q, k, v, lse) instead of
saving them. Here the same two blockwise functions are plain PyTorch inside a
``torch.autograd.Function``, with the same GQA grouping, masks and LSE; the
training path runs them and :func:`dense`. The serving path (a ``cache``
given: prefill, or decode with ``decode_position``) runs forward only, in
the params' dtype (bf16 as the reference serves, or f32): its adapted
projections go through the fused LoRA kernel (``lora_dense``, B3) and the
prefill attention through the flash attention kernel (``swa_attention``,
B8), each in that dtype; decode attends against the cache with
:func:`decode_attention`, in plain PyTorch as the reference does in jnp.
A sliding window (``window`` > 0) masks all three modes alike, and its
layers' caches are rings of ``min(window, cache_len)`` slots.
Cross-attention (an encoder-decoder's) takes k and v from the encoder's
output, never RoPE, attends without a causal mask, and keeps a cross cache
filled once at prefill that decode only reads.
The reference's sharding constraints have no counterpart (one device), and
the port never routes attention to a library kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_swa import swa_attention
from repro_torch.models.common import (Params, apply_rope, make_dense_params,
                                       maybe_lora, project)
from repro_torch.util.device import resolve_device

NEG_INF = -1e30
# the position a cross-attention decode step attends from: past every slot
# of the cross cache, so that all of them are valid (reference :375–377)
CROSS_POSITION = 2 ** 30


def make_attention_params(gen, cfg, lead, dtype, device) -> Params:
    """q/k/v/o kernels of one attention (stacked on the ``lead`` axes),
    q/k/v with zero biases under ``cfg.qkv_bias``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, bias = cfg.num_heads, cfg.num_kv_heads, cfg.qkv_bias
    return {
        "q_proj": make_dense_params(gen, (*lead, d, h * hd), dtype, device,
                                    bias=bias),
        "k_proj": make_dense_params(gen, (*lead, d, kv * hd), dtype, device,
                                    bias=bias),
        "v_proj": make_dense_params(gen, (*lead, d, kv * hd), dtype, device,
                                    bias=bias),
        "o_proj": make_dense_params(gen, (*lead, h * hd, d), dtype, device),
    }


def _block_mask(sq: int, bs: int, blk: int, sk: int, q_offset: int,
                causal: bool, window: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = blk * bs + torch.arange(bs, device=device)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    else:
        mask = torch.ones((sq, bs), dtype=torch.bool, device=device)
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask & (k_pos < sk)[None, :]


def _blocks(k: torch.Tensor, v: torch.Tensor, block_size: int):
    """Pad the key axis to a block multiple: (k, v, block size, #blocks)."""
    sk = k.shape[1]
    bs = min(block_size, sk)
    pad = (-sk) % bs
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, bs, (sk + pad) // bs


def _flash_fwd_impl(q, k, v, causal, window, q_offset, block_size):
    b, sq, h, dk = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // kvh
    qg = q.reshape(b, sq, kvh, group, dk).float() * dk ** -0.5
    k, v, bs, nblocks = _blocks(k, v, block_size)
    acc = torch.zeros((b, kvh, group, sq, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, group, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, group, sq), dtype=torch.float32, device=q.device)
    for blk in range(nblocks):
        kblk = k[:, blk * bs:(blk + 1) * bs]
        vblk = v[:, blk * bs:(blk + 1) * bs]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kblk.float())
        mask = _block_mask(sq, bs, blk, sk, q_offset, causal, window, q.device)
        s = torch.where(mask[None, None, None], s,
                        torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vblk.dtype),
                          vblk).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    lse = m + torch.log(l)  # (b, kvh, group, sq)
    return out.to(v.dtype), lse


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_offset,
                    block_size):
    b, sq, h, dk = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // kvh
    scale = dk ** -0.5
    qg = q.reshape(b, sq, kvh, group, dk).float() * scale
    k, v, bs, nblocks = _blocks(k, v, block_size)
    og = out.reshape(b, sq, kvh, group, dv).permute(0, 2, 3, 1, 4)
    dog = dout.reshape(b, sq, kvh, group, dv).permute(0, 2, 3, 1, 4)
    delta = torch.einsum("bkgqd,bkgqd->bkgq", og.float(), dog.float())
    dq = torch.zeros((b, sq, kvh, group, dk), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for blk in range(nblocks):
        kblk = k[:, blk * bs:(blk + 1) * bs]
        vblk = v[:, blk * bs:(blk + 1) * bs]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kblk.float())
        mask = _block_mask(sq, bs, blk, sk, q_offset, causal, window, q.device)
        s = torch.where(mask[None, None, None], s,
                        torch.tensor(NEG_INF, device=q.device))
        p = torch.exp(s - lse[..., None])  # recomputed probabilities
        dvs.append(torch.einsum("bkgqc,bkgqd->bckd", p.to(dog.dtype),
                                dog).float())
        dp = torch.einsum("bkgqd,bckd->bkgqc", dog, vblk).float()
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgqc,bckd->bqkgd", ds.to(kblk.dtype),
                               kblk).float()
        dks.append(torch.einsum("bkgqc,bqkgd->bckd", ds, qg))
    dq = (dq * scale).reshape(b, sq, h, dk)
    dk_full = torch.cat(dks, dim=1)[:, :sk]
    dv_full = torch.cat(dvs, dim=1)[:, :sk]
    return dq.to(q.dtype), dk_full.to(q.dtype), dv_full.to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_size):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset,
                                   block_size)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset, block_size)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    block_size: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, Dk), k (B, Sk, KV, Dk), v (B, Sk, KV, Dv) → (B, Sq, H, Dv)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 block_size)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

def init_kv_cache(batch: int, length: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> Params:
    """Zero K/V buffers (batch, length, kv_heads, head_dim) and ``pos``
    (length,) int32 = −1: the absolute position each slot holds (−1 =
    empty), so full and ring caches share one code path."""
    dev = resolve_device(device)
    return {
        "k": torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                         device=dev),
        "v": torch.zeros((batch, length, kv_heads, head_dim), dtype=dtype,
                         device=dev),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=dev),
    }


def cache_write(cache: Params, k_new: torch.Tensor, v_new: torch.Tensor,
                position: int) -> Params:
    """Write one step (Sq = 1) at slot ``position % length`` — in place (the
    reference returns a new cache; the port saves the copy) — and return
    the cache."""
    position = int(position)
    slot = position % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = position
    return cache


def _prefill_cache(cache: Params, positions: torch.Tensor,
                   **entries: torch.Tensor) -> Params:
    """Fill the cache's buffers named by ``entries`` (K and V; MLA's c_kv
    and k_rope) with the prompt's, left-aligned (the last ``length``
    positions if the prompt is longer), zeros and pos −1 past them — in
    place (reference :401–413)."""
    ppos = positions[-cache["pos"].shape[0]:]
    n = ppos.shape[0]
    for name, t in entries.items():
        cache[name][:, :n] = t[:, -n:].to(cache[name].dtype)
        cache[name][:, n:] = 0
    cache["pos"][:n] = ppos.to(torch.int32)
    cache["pos"][n:] = -1
    return cache


def decode_attention(q: torch.Tensor, cache: Params, position: int,
                     window: int = 0) -> torch.Tensor:
    """Single-query attention against a (possibly ring) cache, with the
    reference's casts: q (B, 1, H, Dk) scaled in its own dtype, scores in
    f32 against K, the softmax's p cast to V's dtype, the PV product summed
    in f32 and returned in V's dtype, (B, 1, H, Dv)."""
    b, _, h, dk = q.shape
    kvh = cache["k"].shape[2]
    group = h // kvh
    position = int(position)
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= position)
    if window:
        valid = valid & (pos > position - window)
    qg = q.reshape(b, kvh, group, dk) * dk ** -0.5
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache["k"].float())
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    vdt = cache["v"].dtype
    out = torch.einsum("bkgc,bckd->bkgd", p.to(vdt).float(),
                       cache["v"].float())
    return out.reshape(b, 1, h, cache["v"].shape[-1]).to(vdt)


# --------------------------------------------------------------------------
# attention block
# --------------------------------------------------------------------------

def attention_block(cfg, params: Params, x: torch.Tensor, *,
                    lora: Optional[Params] = None, lora_scale: float = 0.0,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: int = 0,
                    kv_x: Optional[torch.Tensor] = None,
                    cross: Optional[bool] = None,
                    cache: Optional[Params] = None,
                    decode_position: Optional[Union[int, torch.Tensor]] = None,
                    fused: Optional[bool] = None):
    """Attention over ``x (B, S, d_model)``; returns ``(output, cache)`` as
    the reference does. Self-attention by default: causal unless
    ``causal=False`` (an encoder's), and ``window`` > 0 limits each query
    to the ``window`` latest positions (query − key < window) in all
    three modes. Cross-attention (``kv_x`` given, or ``cross=True``) takes
    k and v from ``kv_x`` (B, Sk, d_model), applies no RoPE and no causal
    mask.

    Training: ``cache=None``. Serving: prefill (``cache`` given) fills the
    cache in place (a ring cache shorter than the prompt keeps its tail; a
    cross cache takes kv_x's k and v at positions 0..Sk − 1) and runs the
    flash attention kernel; decode
    (``decode_position`` given, S = 1) writes the step into a self cache
    at ``position % length`` and attends against it, or reads a cross
    cache as it is (no k, v projection: the reference's
    ``k = v = None``). ``fused`` picks the serving kernels — the fused LoRA
    kernel for the adapted projections and the flash attention kernel —
    and defaults to whether a cache is given (an encoder's serving pass
    has none and passes ``fused=True``); without it the projections are
    :func:`dense` and the attention the autograd :func:`flash_attention`.
    """
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    decode = decode_position is not None
    if decode and cache is None:
        raise ValueError("attention_block: decode needs a cache")
    if cross is None:
        cross = kv_x is not None
    if cross and kv_x is None and not decode:
        raise ValueError("attention_block: cross-attention needs kv_x "
                         "outside decode")
    if fused is None:
        fused = cache is not None

    def proj(inp, name):
        return project(inp, params[name], maybe_lora(lora, name), lora_scale,
                       fused)

    q = proj(x, "q_proj").reshape(b, sq, h, hd)
    if cross and decode:
        k = v = None  # the cross cache was filled at prefill; only read
    else:
        src = kv_x if cross else x
        sk = src.shape[1]
        k = proj(src, "k_proj").reshape(b, sk, kvh, hd)
        v = proj(src, "v_proj").reshape(b, sk, kvh, hd)
    if decode:
        # torch.full, not torch.tensor: no blocking host-to-device copy
        positions = torch.full((1,), int(decode_position), device=x.device)
    elif positions is None:
        positions = torch.arange(sq, device=x.device)
    if cfg.rope and not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if decode and cross:
        out = decode_attention(q, cache, CROSS_POSITION)
    elif decode:
        cache_write(cache, k, v, decode_position)
        out = decode_attention(q, cache, decode_position, window=window)
    else:
        if cache is not None:
            kpos = (torch.arange(k.shape[1], device=x.device) if cross
                    else positions)
            _prefill_cache(cache, kpos, k=k, v=v)
        attend = swa_attention if fused else flash_attention
        out = attend(q, k, v, causal=causal and not cross, window=window)
    out = out.reshape(b, sq, h * hd).to(x.dtype)
    return proj(out, "o_proj").to(x.dtype), cache
