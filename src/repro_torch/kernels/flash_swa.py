"""Causal / sliding-window flash attention, forward.

Replaces the TPU kernel ``repro/kernels/flash_swa.py::flash_swa`` (body
``_kernel``; wrapper ``ops.swa_attention``). The serving path's prefill
(``models/attention.py``) runs every layer's attention through
:func:`swa_attention` with ``causal=True, window=0``: one launch a layer.

* CUDA kernel: ``csrc/flash_swa.cu``. One block per (batch·head, 64 query
  rows); K/V tiles of 64 positions through shared memory, online softmax
  with m and l per row, IEEE f32 FMAs on CUDA cores, scale d^-½ applied to
  q in f32, masked scores −1e30, l clamped at 1e-30. KV tiles outside the
  causal ∩ window band are skipped. Rows and columns past S are masked,
  so any S runs the kernel (the reference wrapper falls back to
  ``ref.flash_swa_ref`` when S cannot be tiled; the port has no fallback).
  Bound on the card: operations, 4·d FLOPs per visible (query, key) pair.
* Plain versions: :func:`flash_swa_plain` is the materialised oracle
  ``ref.flash_swa_ref`` (softmax in f32); :func:`swa_attention_plain` the
  same per GQA group on (B, S, H, D). The CPU path and the tests use them;
  nothing on the card's main path does.
* :func:`flash_swa` (BH, S, D) and :func:`swa_attention` (B, S, H, D) are
  the wrappers: each launches the kernel for CUDA tensors (counting
  ``flash_swa.launches``), raises on a failed launch, and takes the plain
  version only for CPU tensors. :func:`swa_attention` reads query head h's
  K/V head h // (H/KVH) in place through strides — the reference's
  ``jnp.repeat`` map with no copy of K and V.

Forward only: an input that requires grad is refused. f32 only (the JAX
kernel also takes bf16, not ported).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load_library

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # shared memory: Q, K/V tiles of 64 × d f32


def _mask(sq: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    return mask


def flash_swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Materialised attention oracle (``ref.flash_swa_ref``): q, k, v
    (BH, S, D) → (BH, Sq, D) f32."""
    sq, d = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    s = s.masked_fill(~_mask(sq, k.shape[1], causal, window, q.device)[None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float())


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_swa_plain` per GQA group: q (B, Sq, H, D), k, v
    (B, Sk, KVH, D) → (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * d ** -0.5
    s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _check(name: str, q, k, v, ndim: int) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype} "
                            "(the bf16 variant is not ported)")
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}, q on {q.device}")
        if t.requires_grad:
            raise ValueError(f"{name}: {arg} requires grad — the kernel is "
                             "forward only")
        if t.ndim != ndim:
            raise ValueError(f"{name}: {arg} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _launch(name, q, k, v, out, b, h, kvh, strides, causal, window):
    """One kernel launch; ``strides`` are the (batch, position, head)
    element strides of q, k, v and out."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    sq, d, sk = q.shape[1], q.shape[-1], k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} (shared "
                         "memory)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if b * h > 65535:
        raise ValueError(f"{name}: batch·heads {b * h} > 65535 (grid)")
    vec = int(d % 4 == 0 and all(s % 4 == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    lib = load_library()
    st = (ctypes.c_int64 * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_swa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, d, st, int(bool(causal)), int(window),
            float(d ** -0.5), vec, stream)
    check_launch(name, code)
    flash_swa.launches += 1
    return out


def flash_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v (BH, S, D) f32 → a new (BH, Sq, D) f32 attention output."""
    _check("flash_swa", q, k, v, 3)
    if q.device.type == "cpu":
        return flash_swa_plain(q, k, v, causal, window)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    strides = (q.stride(0), q.stride(1), 0, k.stride(0), k.stride(1), 0,
               v.stride(0), v.stride(1), 0, out.stride(0), out.stride(1), 0)
    return _launch("flash_swa", q, k, v, out, q.shape[0], 1, 1, strides,
                   causal, window)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k, v (B, Sk, KVH, D) f32 → a new (B, Sq, H, D) f32
    output; query head h attends with K/V head h // (H/KVH)."""
    _check("swa_attention", q, k, v, 4)
    b, _, h, _ = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"swa_attention: {h} query heads over {kvh} KV heads")
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, causal, window)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    return _launch("swa_attention", q, k, v, out, b, h, kvh, strides, causal,
                   window)


flash_swa.launches = 0
