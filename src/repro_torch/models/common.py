"""Shared model primitives: norms, RoPE, dense (with LoRA hook), embeddings.

Counterpart of ``repro/models/common.py``; same conventions:

* Kernels are stored ``(d_in, d_out)``; activations are ``x @ kernel``.
* LoRA factors are stored ``a: (d_in, r)``, ``b: (r, d_out)``, so the adapter
  update is ``ΔW = a @ b`` (the paper's ``B A`` transposed).
* Norm row statistics, softmax and logits are f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.lora_matmul import lora_dense

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# initializers (the port's own draws; parity tests bridge the reference's)
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, device,
                stddev: float = 0.02) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(0.0, stddev, generator=gen)
    return x.to(dtype)


def stacked_normal(gen: torch.Generator, shape, lead, dtype, device,
                   stddev: float = 0.02) -> torch.Tensor:
    """N(0, stddev²) draws of ``shape`` (``(*lead, …)``), one layer of the
    ``lead`` axes at a time, so that a bf16 leaf never has a float32 copy of
    its whole size (one layer of mixtral's expert stack is 3.2 GB in
    float32, zamba2's stacked ``in_proj`` 16.2 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    per_layer = out.view(-1, *shape[len(lead):])
    for layer in per_layer:
        layer.copy_(normal_init(gen, layer.shape, dtype, device, stddev))
    return out


def make_dense_params(gen, shape_in_out, dtype, device, *,
                      bias: bool = False) -> Params:
    """``kernel`` of ``shape_in_out`` = ``(*lead, d_in, d_out)`` drawn
    N(0, 0.02²); with ``bias`` a zero ``bias`` of ``(*lead, d_out)``."""
    p = {"kernel": normal_init(gen, shape_in_out, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((*shape_in_out[:-2], shape_in_out[-1]),
                                dtype=dtype, device=device)
    return p


def make_norm_params(kind: str, shape, dtype, device) -> Params:
    """Unit ``scale`` of ``shape`` (``(*lead, d)``); LayerNorm adds a zero
    ``bias``."""
    ones = torch.ones(shape, dtype=dtype, device=device)
    if kind == "rmsnorm":
        return {"scale": ones}
    if kind == "layernorm":
        return {"scale": ones,
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    raise ValueError(f"unknown norm {kind!r}")


# --------------------------------------------------------------------------
# dense + LoRA
# --------------------------------------------------------------------------

def dense(x: torch.Tensor, params: Params, lora: Optional[Params] = None,
          lora_scale: float = 0.0) -> torch.Tensor:
    """``x @ kernel (+ bias)``, with an optional LoRA adapter branch
    ``scale * (x @ a) @ b`` — the rank-r intermediate stays tiny.

    Lane-stacked adapters ``a (C, m, r)``, ``b (C, r, n)`` (mesh mode's
    co-scheduled clients) split x's rows into C equal blocks, lane-major:
    lane c's factors apply to the c-th block only."""
    y = torch.matmul(x, params["kernel"])
    if lora is not None:
        a = lora["a"].to(x.dtype)
        b = lora["b"].to(x.dtype)
        if a.ndim == 3:
            lanes = x.reshape(a.shape[0], -1, x.shape[-1])
            y = y + lora_scale * torch.bmm(torch.bmm(lanes, a), b).reshape(
                y.shape)
        else:
            y = y + lora_scale * torch.matmul(torch.matmul(x, a), b)
    if "bias" in params:
        y = y + params["bias"]
    return y


def project(x: torch.Tensor, params: Params, lora: Optional[Params],
            lora_scale: float, fused: bool) -> torch.Tensor:
    """:func:`dense`, or with ``fused`` and an adapter the fused LoRA
    projection (``kernels.lora_dense``: the B3 kernel on the card, forward
    only) — the serving path's projections. The adapter's factors are cast
    to x's dtype first, as :func:`dense` casts them (an f32 adapter on a
    bf16 model runs the bf16 kernel)."""
    if not (fused and lora is not None):
        return dense(x, params, lora, lora_scale)
    y = lora_dense(x, params["kernel"], lora["a"].to(x.dtype),
                   lora["b"].to(x.dtype), lora_scale)
    if "bias" in params:
        y = y + params["bias"]
    return y


def maybe_lora(lora: Optional[Params], name: str) -> Optional[Params]:
    if lora is None:
        return None
    return lora.get(name)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------

def apply_norm(kind: str, params: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Pre-norm with f32 row statistics and tensor math in ``x.dtype``,
    op for op the reference's (not ``F.layer_norm``, whose op order gives
    another bf16 function). LayerNorm's variance is the population one, as
    ``jnp.var``'s."""
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * params["scale"].to(x.dtype)
    if kind == "layernorm":
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        inv = torch.rsqrt(var + eps)
        y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
        return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)
    raise ValueError(f"unknown norm {kind!r}")


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``silu``, or ``gelu`` in its tanh form (``jax.nn.gelu``'s default
    ``approximate=True``; torch's default is the erf form)."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x (..., seq, heads, head_dim)``; ``positions`` is ``(seq,)``."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# embeddings / unembedding / loss
# --------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params: Params, x: torch.Tensor, *,
            tied_embedding: Optional[torch.Tensor] = None,
            lora: Optional[Params] = None,
            lora_scale: float = 0.0) -> torch.Tensor:
    if tied_embedding is not None:
        logits = torch.matmul(x, tied_embedding.t().to(x.dtype))
    else:
        logits = dense(x, params, lora=lora, lora_scale=lora_scale)
    return logits.float()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE with optional loss mask. Returns (mean_loss, metrics)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((torch.argmax(logits, -1) == targets).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
