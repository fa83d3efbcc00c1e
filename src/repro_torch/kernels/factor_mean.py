"""Weighted LoRA factor mean  x̄ = Σ_c w_c · x_c  over a stacked client axis.

Replaces the TPU kernel ``repro/kernels/factor_mean.py::lora_factor_mean``
(bodies ``_kernel`` / ``_kernel_weighted``; wrapper ``ops.factor_mean``).
The round-close engine reduces the engine's ``(C_max, L, m, n)`` factor
stacks to the global factors ā and b̄ with it: one launch per factor leaf.

* CUDA kernel: ``csrc/factor_mean.cu`` (one thread per output element,
  grid-stride, coalesced over every lane). Bound on the card: bytes,
  (C_live + 1)·L·m·n·4 — at the engine's factor sizes (~2.3 M elements per
  lane at paper-llama3.2-3b width) a launch moves a few MB, so it is
  launch-bound in practice. A zero-weight lane is never read (adds exactly 0).
* Plain version :func:`factor_mean_plain`: the same arithmetic in PyTorch
  ops (slot-order sum; the kernel rounds every product and sum like separate
  PyTorch ops, so the two agree bitwise on finite inputs). The CPU path and
  the tests use it; nothing on the card's main path does.
* :func:`factor_mean` is the wrapper: it launches the kernel for CUDA tensors
  (counting ``factor_mean.launches``), raises on a failed launch, and takes
  the plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import check_launch, load_library


def factor_mean_plain(stack: torch.Tensor,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, *dims) → (*dims) f32: Σ_c w_c x_c, or with ``weights=None`` the
    slot-order sum divided by C."""
    x = stack.float()
    c = x.shape[0]
    if weights is None:
        acc = x[0]
        for i in range(1, c):
            acc = acc + x[i]
        return acc / c
    acc = torch.zeros_like(x[0])
    for i in range(c):
        acc = acc + weights[i] * x[i]
    return acc


def _check(stack: torch.Tensor, weights: Optional[torch.Tensor]) -> None:
    if stack.dtype != torch.float32:
        raise TypeError(f"factor_mean: stack must be float32, got {stack.dtype}")
    if stack.ndim < 2 or stack.shape[0] < 1:
        raise ValueError(f"factor_mean: need a (C, ...) stack, got "
                         f"{tuple(stack.shape)}")
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != stack.shape[:1]:
            raise ValueError(
                f"factor_mean: weights must be float32 of shape "
                f"({stack.shape[0]},), got {weights.dtype} "
                f"{tuple(weights.shape)}")
        if weights.device != stack.device:
            raise ValueError("factor_mean: weights and stack on different "
                             f"devices ({weights.device} vs {stack.device})")


def factor_mean(stack: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_c w_c·x_c over the leading client axis of ``stack`` (C, *dims).

    ``weights`` — optional (C,) float32 normalised weights on the stack's
    device (zeros mask lanes); ``None`` → uniform slot-order mean. Returns a
    new (*dims) float32 tensor.
    """
    _check(stack, weights)
    if stack.device.type == "cpu":
        return factor_mean_plain(stack, weights)
    if stack.device.type != "cuda":
        raise ValueError(f"factor_mean: unsupported device {stack.device}")
    if not stack[0].is_contiguous():
        raise ValueError("factor_mean: each client lane must be contiguous "
                         f"(strides {stack.stride()})")
    if weights is not None and not weights.is_contiguous():
        raise ValueError("factor_mean: weights must be contiguous")
    out = torch.empty(stack.shape[1:], dtype=torch.float32,
                      device=stack.device)
    lib = load_library()
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.factor_mean_launch(
            stack.data_ptr(), out.data_ptr(),
            None if weights is None else weights.data_ptr(),
            stack.shape[0], out.numel(), stack.stride(0), stream)
    check_launch("factor_mean", code)
    factor_mean.launches += 1
    return out


factor_mean.launches = 0
