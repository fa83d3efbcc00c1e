"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060), the
counterpart of ``repro/models/ssm.py``.

Training and prefill run the chunked SSD algorithm: within a chunk a
quadratic, attention-like product under a decay mask; across chunks a
recurrence over the per-chunk states, here a Python loop over the chunks
where the reference scans. Decode is the O(1) recurrent update of the
carried state ``h`` (B, H, P, N). The reference has no Pallas kernel here:
``ssd_chunked`` and ``ssd_step`` are ``jnp.einsum`` and ``lax.scan``, and
the causal conv a loop of shifted products, so the port computes all three
in torch ops, on the card too. Serving's ``in_proj`` and ``out_proj`` run
the fused LoRA kernel (B3), as every adapted projection of serving does.

Rounding follows the reference's: the SSD's products are f32 (``jnp.einsum``
promotes a bf16 x against the f32 dt, B and C; the port casts x to f32
where JAX promotes it), its output is cast back to x's dtype; prefill adds
the skip ``x·D`` in x's dtype, decode in f32; the gated norm multiplies by
silu(z) in y's dtype before it widens.

LoRA targets: ``in_proj`` / ``out_proj``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, maybe_lora, project,
                                       stacked_normal)
from repro_torch.util.device import resolve_device


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n  # x, B, C all pass through the causal conv
    return d_inner, nheads, n, conv_ch


def make_mamba2_params(gen, cfg, dtype, device, lead=()) -> Params:
    """One Mamba2 block's leaves, stacked on the ``lead`` axes: ``in_proj``
    (d → z, x, B, C, dt: 2·d_inner + 2·N + H), the depthwise ``conv``
    (kernel N(0, 0.1²), zero bias) over x, B and C, ``norm``, ``out_proj``
    (d_inner → d) in ``dtype``; ``A_log`` = log(linspace(1, 16, H)), ``D``
    = 1 and ``dt_bias`` = 0 in f32 whatever ``dtype`` is, as the
    reference's. The kernels are drawn a layer at a time
    (:func:`~repro_torch.models.common.stacked_normal`)."""
    d = cfg.d_model
    d_inner, nheads, n, conv_ch = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * n + nheads
    a_init = torch.log(torch.linspace(1.0, 16.0, nheads, device=device))

    def per_head(x):
        return x.expand(*lead, nheads).clone()

    return {
        "in_proj": {"kernel": stacked_normal(gen, (*lead, d, d_in_proj),
                                             lead, dtype, device)},
        "conv": {
            "kernel": stacked_normal(gen, (*lead, cfg.ssm_conv, conv_ch),
                                     lead, dtype, device, stddev=0.1),
            "bias": torch.zeros((*lead, conv_ch), dtype=dtype,
                                device=device),
        },
        "A_log": per_head(a_init),
        "D": per_head(torch.ones(nheads, device=device)),
        "dt_bias": per_head(torch.zeros(nheads, device=device)),
        "norm": {"scale": torch.ones((*lead, d_inner), dtype=dtype,
                                     device=device)},
        "out_proj": {"kernel": stacked_normal(gen, (*lead, d_inner, d),
                                              lead, dtype, device)},
    }


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d (torch ops, no kernel). x: (B, S, C);
    kernel: (K, C). Returns ``(silu(y), new_state)``, the state the last
    K − 1 inputs. As ``jnp.concatenate`` does, the state and x are joined
    in their promoted dtype, so the new state of f32 activations against a
    bf16 state comes back in f32."""
    k = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    joined = torch.promote_types(state.dtype, x.dtype)
    xx = torch.cat([state.to(joined), x.to(joined)], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    # windows: y_t = Σ_j kernel[j] * xx[t+j]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + xx[:, j:j + s].float() * kernel[j].float()
    y = (y + bias.float()).to(x.dtype)
    new_state = xx[:, -(k - 1):] if k > 1 else state
    return F.silu(y), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = Σ_{j < l <= i} x[..., l] (−inf above the
    diagonal), as the reference's difference of inclusive cumsums (not the
    "stable" segment sum of Mamba's own code, which rounds otherwise)."""
    t = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in torch ops (the reference's ``jnp.einsum`` and
    ``lax.scan``; no kernel).

    x:  (B, S, H, P) inputs per head
    dt: (B, S, H)    positive step sizes
    a:  (H,)         negative per-head decay
    b:  (B, S, N)    input projections (shared across heads, n_groups=1)
    c:  (B, S, N)    output projections
    h0: (B, H, P, N) initial state
    → (y (B,S,H,P) in x's dtype, h_final (B,H,P,N))

    The intra-chunk product ``y_diag`` contracts its four operands in this
    order: the (B, NC, H, L, L) decay mask times C·Bᵀ, times dt over the
    source position, then one batched product with x over the source
    position; so at most two mask-sized f32 tensors live at once (470 MB
    each at batch 8 × 512, chunk 256, 112 heads).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk

    # jnp.einsum promotes a bf16 x against the f32 dt, B and C
    xc = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    da = dtc * a  # (B, NC, L, H) log-decay per step
    da_cs = torch.cumsum(da, dim=2)  # inclusive cumsum within the chunk

    # ---- intra-chunk (diagonal) term ------------------------------------
    # lmat[i, j] = exp(Σ_{j<l<=i} da_l): (B, NC, H, L, L)
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))
    cb = torch.einsum("bzln,bzmn->bzlm", cc, bc)  # (B, NC, L, L)
    w = lmat * cb[:, :, None]
    del lmat
    w = w * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bzhlm,bzmhp->bzlhp", w, xc)
    del w

    # ---- per-chunk final states -----------------------------------------
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B, NC, L, H)
    states = torch.einsum("bzlhp,bzln->bzhpn",
                          xc * (decay_to_end * dtc)[..., None], bc)

    # ---- inter-chunk recurrence over the chunk states -------------------
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # (B, NC, H)
    hs = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0)
    enter = []
    for z in range(nc):
        enter.append(hs)  # the state ENTERING chunk z
        hs = hs * chunk_decay[:, z, :, None, None] + states[:, z]
    h_enter = torch.stack(enter, dim=1)  # (B, NC, H, P, N)

    # ---- inter-chunk (off-diagonal) output ------------------------------
    state_decay = torch.exp(da_cs)  # decay from the chunk's start to l
    y_off = (torch.einsum("bzln,bzhpn->bzlhp", cc, h_enter)
             * state_decay[..., None])

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), hs


def ssd_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step (torch ops, no kernel). h: (B,H,P,N); x: (B,H,P);
    dt: (B,H); b, c: (B,N)."""
    decay = torch.exp(dt * a)  # (B, H)
    inp = (dt[:, :, None, None] * b[:, None, None, :]) * x[..., None]
    h_new = h * decay[..., None, None] + inp
    y = torch.einsum("bn,bhpn->bhp", c, h_new.to(c.dtype))
    return h_new, y


def init_mamba_cache(batch: int, cfg, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """``ssm`` (batch, H, P, N) f32 and ``conv`` (batch, K − 1, conv_ch)
    in ``dtype``, zero."""
    _, nheads, n, conv_ch = _dims(cfg)
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((batch, nheads, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=dev),
    }


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``, with no
    switch to x above 20 as ``F.softplus`` has (the two agree in f32 there
    only to within its rounding)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _store(cache: Params, key: str, value: torch.Tensor) -> None:
    """Write ``value`` into ``cache[key]`` in place, or, where its dtype
    differs (the conv state of f32 activations against a bf16 buffer),
    replace the entry, as the reference's new cache carries that dtype;
    :func:`~repro_torch.models.transformer.forward` widens the stacked
    buffers first, so that its layers' writes land in place."""
    if cache[key].dtype == value.dtype:
        cache[key].copy_(value)
    else:
        cache[key] = value


def mamba2_block(cfg, params: Params, x: torch.Tensor, *,
                 lora: Optional[Params] = None, lora_scale: float = 0.0,
                 cache: Optional[Params] = None, decode: bool = False,
                 chunk: int = 256) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d_model) → (y, cache).

    Training: ``cache=None``. Serving: prefill (a ``cache``) and decode
    (``decode=True``, S = 1) update the cache's ``ssm`` and ``conv`` in
    place and run ``in_proj`` / ``out_proj`` through the fused LoRA kernel.
    A sequence longer than ``chunk`` is padded to a multiple of it with dt
    0 (so the final state stays exact) and runs chunk by chunk; one of at
    most ``chunk`` tokens runs as a single chunk of its own length, which
    the reference's padding to ``chunk`` computes too, with zero terms
    added."""
    bsz, s, _ = x.shape
    d_inner, nheads, n, conv_ch = _dims(cfg)
    p_dim = cfg.ssm_head_dim
    serving = cache is not None
    if decode and not (serving and s == 1):
        raise ValueError("mamba2_block: decode takes one token and a cache")

    def proj(inp, name):
        return project(inp, params[name], maybe_lora(lora, name), lora_scale,
                       serving)

    zxbcdt = proj(x, "in_proj")
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_pre = zxbcdt[..., d_inner + conv_ch:]  # (B, S, H)

    xbc, new_conv = _causal_conv(xbc, params["conv"]["kernel"],
                                 params["conv"]["bias"],
                                 cache["conv"] if serving else None)
    xs = xbc[..., :d_inner]
    b = xbc[..., d_inner:d_inner + n]
    c = xbc[..., d_inner + n:]

    a = -torch.exp(params["A_log"])  # (H,)
    dt = _softplus(dt_pre.float() + params["dt_bias"])  # (B, S, H)
    xh = xs.reshape(bsz, s, nheads, p_dim)

    if decode:
        h_new, y = ssd_step(cache["ssm"], xh[:, 0].float(), dt[:, 0], a,
                            b[:, 0].float(), c[:, 0].float())
        y = y[:, None]  # (B, 1, H, P)
    else:
        pad = (-s) % chunk if s > chunk else 0
        xh_p, dt_p, b_p, c_p = xh, dt, b, c
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            b_p = F.pad(b, (0, 0, 0, pad))
            c_p = F.pad(c, (0, 0, 0, pad))
        y, h_new = ssd_chunked(xh_p, dt_p, a, b_p.float(), c_p.float(),
                               chunk=chunk,
                               h0=cache["ssm"] if serving else None)
        y = y[:, :s]
    if serving:
        _store(cache, "ssm", h_new)
        _store(cache, "conv", new_conv)

    y = y + xh.to(y.dtype) * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, params["norm"]["scale"])
    return proj(y, "out_proj").to(x.dtype), cache
