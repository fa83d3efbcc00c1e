"""FedEx-LoRA exact residual fold:  W0 + scale·(Σ_c w_c a_c b_c − ā b̄).

Replaces the TPU kernel ``repro/kernels/fedex_residual.py::
fedex_residual_apply`` (bodies ``_kernel`` / ``_kernel_weighted``; wrapper
``ops.fedex_fold``), with ā = Σ_c w_c a_c and b̄ = Σ_c w_c b_c. The weighted
body closes weighted and partial rounds in the engine; the uniform body
(``weights=None``: slot-order client sums, each divided by C at the end) is
the reference's ``apply_residual_fused`` path.

* CUDA kernel: ``csrc/fedex_fold.cu``. One block per 32×128 output tile and
  the stacked-layer axis on the grid (one launch per adapter leaf). Clients
  stream through shared memory one at a time, so shared memory does not grow
  with C; ā b̄ is recomputed per tile and the dense residual never reaches
  device memory; products in IEEE f32 on CUDA cores. Bound on the card:
  bytes, 8·L·m·n (one f32 read and one f32 write of W0 per element). The
  factor stacks are read in the engine's client-leading ``(C, L, m, r)`` /
  ``(C, L, r, n)`` layout through their strides; the fold may write into
  W0's own storage (``out=w0``). A zero-weight lane is never read.
* Plain version :func:`fedex_fold_plain`: the same op order in PyTorch
  (``torch.matmul`` for the rank-r products). The CPU path and the tests use
  it; nothing on the card's main path does.
* :func:`fedex_fold` is the wrapper: it launches the kernel for CUDA tensors
  (counting ``fedex_fold.launches``), raises on a failed launch, and takes
  the plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RANK = 128  # shared memory: r · 1280 bytes per block


def fedex_fold_plain(w0: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, scale: float,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w0 (*L, m, n), a (C, *L, m, r), b (C, *L, r, n) → (*L, m, n) f32."""
    a, b = a_stack.float(), b_stack.float()
    c = a.shape[0]
    if weights is None:
        mean_prod = torch.matmul(a[0], b[0])
        abar, bbar = a[0], b[0]
        for i in range(1, c):
            mean_prod = mean_prod + torch.matmul(a[i], b[i])
            abar = abar + a[i]
            bbar = bbar + b[i]
        mean_prod = mean_prod / c
        abar = abar / c
        bbar = bbar / c
    else:
        mean_prod = torch.zeros(w0.shape, dtype=torch.float32,
                                device=w0.device)
        abar = torch.zeros_like(a[0])
        bbar = torch.zeros_like(b[0])
        for i in range(c):
            wc = weights[i]
            mean_prod = mean_prod + wc * torch.matmul(a[i], b[i])
            abar = abar + wc * a[i]
            bbar = bbar + wc * b[i]
    residual = mean_prod - torch.matmul(abar, bbar)
    return w0.float() + scale * residual


def _check(w0, a, b, weights):
    for name, t in (("w0", w0), ("a_stack", a), ("b_stack", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"fedex_fold: {name} must be float32, got {t.dtype}")
        if t.device != w0.device:
            raise ValueError(f"fedex_fold: {name} on {t.device}, w0 on "
                             f"{w0.device}")
    if w0.ndim not in (2, 3):
        raise ValueError(f"fedex_fold: w0 must be (m, n) or (L, m, n), got "
                         f"{tuple(w0.shape)}")
    lead, (m, n) = tuple(w0.shape[:-2]), tuple(w0.shape[-2:])
    if a.ndim != w0.ndim + 1 or b.ndim != w0.ndim + 1:
        raise ValueError("fedex_fold: a_stack / b_stack need a leading client "
                         f"axis: got {tuple(a.shape)}, {tuple(b.shape)} for "
                         f"w0 {tuple(w0.shape)}")
    c, r = a.shape[0], a.shape[-1]
    if (tuple(a.shape) != (c, *lead, m, r)
            or tuple(b.shape) != (c, *lead, r, n)):
        raise ValueError(f"fedex_fold: shapes disagree: w0 {tuple(w0.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != (c,)
                                or weights.device != w0.device):
        raise ValueError(f"fedex_fold: weights must be float32 ({c},) on "
                         f"{w0.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    return c, m, n, r


def fedex_fold(w0: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
               scale: float, *, weights: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W0 + scale·ΔW_res for w0 (m, n) or (L, m, n), client-leading
    a_stack (C, [L,] m, r) and b_stack (C, [L,] r, n), float32.

    ``weights`` — optional (C,) normalised weights (zeros mask lanes);
    ``None`` → the uniform body. ``out`` may be ``w0`` itself (in-place
    fold); by default a new tensor is returned.
    """
    c, m, n, r = _check(w0, a_stack, b_stack, weights)
    if w0.device.type == "cpu":
        res = fedex_fold_plain(w0, a_stack, b_stack, scale, weights)
        return res if out is None else out.copy_(res)
    if w0.device.type != "cuda":
        raise ValueError(f"fedex_fold: unsupported device {w0.device}")
    if r > MAX_RANK:
        raise ValueError(f"fedex_fold: rank {r} > {MAX_RANK} (shared memory)")
    if not w0.is_contiguous():
        raise ValueError("fedex_fold: w0 must be contiguous")
    if a_stack.stride()[-2:] != (r, 1) or b_stack.stride()[-2:] != (n, 1):
        raise ValueError("fedex_fold: the trailing (m, r) / (r, n) dims of the "
                         f"factor stacks must be contiguous (strides "
                         f"{a_stack.stride()}, {b_stack.stride()})")
    if weights is not None and not weights.is_contiguous():
        raise ValueError("fedex_fold: weights must be contiguous")
    if out is None:
        out = torch.empty_like(w0)
    elif (out.shape != w0.shape or out.dtype != torch.float32
          or out.device != w0.device or not out.is_contiguous()):
        raise ValueError("fedex_fold: out must be a contiguous float32 tensor "
                         "shaped like w0")
    layers = w0.shape[0] if w0.ndim == 3 else 1
    sa_l = a_stack.stride(1) if w0.ndim == 3 else 0
    sb_l = b_stack.stride(1) if w0.ndim == 3 else 0
    lib = load_library()
    with torch.cuda.device(w0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fedex_fold_launch(
            w0.data_ptr(), out.data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(),
            None if weights is None else weights.data_ptr(),
            c, layers, m, n, r, a_stack.stride(0), sa_l, b_stack.stride(0),
            sb_l, float(scale), stream)
    check_launch("fedex_fold", code)
    fedex_fold.launches += 1
    return out


fedex_fold.launches = 0


def fold_error_bound(w0: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, scale: float,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise bound on how far two f32 evaluations of the fold may
    differ when they sum in other orders (FMA contraction, matmul blocking).

    Each term of W0 + scale·(Σ_c w_c a_c b_c − ā b̄) passes through at most
    C + r + 4 roundings, each off by ≤ u = 2⁻²⁴ relative to the magnitude it
    carries, so either evaluation is within (C + r + 4)·u·M of the exact
    value, with M = |W0| + |scale|·(Σ_c |w_c| |a_c| |b_c| + |ā| |b̄|) and
    |ā| ≤ Σ_c |w_c| |a_c|. Two evaluations are within twice that.
    """
    a, b = a_stack.float().abs(), b_stack.float().abs()
    c, r = a.shape[0], a.shape[-1]
    w = (torch.full((c,), 1.0 / c, device=a.device) if weights is None
         else weights.abs())
    mag = torch.zeros(w0.shape, dtype=torch.float32, device=w0.device)
    abar, bbar = torch.zeros_like(a[0]), torch.zeros_like(b[0])
    for i in range(c):
        mag = mag + w[i] * torch.matmul(a[i], b[i])
        abar = abar + w[i] * a[i]
        bbar = bbar + w[i] * b[i]
    mag = w0.float().abs() + abs(scale) * (mag + torch.matmul(abar, bbar))
    return 2 * (c + r + 4) * 2.0 ** -24 * mag
