"""Attention: GQA with RoPE, blockwise flash attention with its own backward.

Counterpart of ``repro/models/attention.py``, training path only. The
reference's ``flash_attention`` is a jnp ``custom_vjp`` (not a Pallas kernel):
a scan over KV blocks with an online-softmax carry forward, and a backward
that recomputes the probabilities per block from (q, k, v, lse) instead of
saving them. Here the same two blockwise functions are plain PyTorch inside a
``torch.autograd.Function``, with the same GQA grouping, masks and LSE. The
reference's sharding constraints have no counterpart (one device), and the
port never routes attention to a library kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, apply_rope, dense, maybe_lora

NEG_INF = -1e30


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


def attention_block(cfg, params: Params, x: torch.Tensor, *,
                    lora: Optional[Params] = None, lora_scale: float = 0.0,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal self-attention over ``x (B, S, d_model)``, training path."""
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = dense(x, params["q_proj"], maybe_lora(lora, "q_proj"), lora_scale)
    k = dense(x, params["k_proj"], maybe_lora(lora, "k_proj"), lora_scale)
    v = dense(x, params["v_proj"], maybe_lora(lora, "v_proj"), lora_scale)
    q = q.reshape(b, sq, h, hd)
    k = k.reshape(b, sq, kvh, hd)
    v = v.reshape(b, sq, kvh, hd)
    if positions is None:
        positions = torch.arange(sq, device=x.device)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v)
    out = out.reshape(b, sq, h * hd).to(x.dtype)
    out = dense(out, params["o_proj"], maybe_lora(lora, "o_proj"), lora_scale)
    return out.to(x.dtype)
