"""Fused LoRA projection  y = x @ W + scale · (x @ a) @ b.

Replaces the TPU kernel ``repro/kernels/lora_matmul.py::lora_matmul`` (body
``_kernel``; wrapper ``ops.lora_dense``). The serving path
(``models/attention.py``, prefill and decode) runs every adapted q/k/v/o
projection through :func:`lora_dense`: 4 launches a layer.

* CUDA kernel: ``csrc/lora_matmul.cu``. IEEE f32 on CUDA cores (TF32 stays
  off). For M > 16 a prepass grid writes x@a (M × r) into a work buffer,
  then a register-tiled SIMT GEMM (128 × 128 block tiles, K streamed in
  slices of 64 through a 2-stage cp.async ring in shared memory) adds
  scale·(x@a)@b in its epilogue; bound by operations at prefill shapes.
  For M ≤ 16 (decode) a split-K body whose grid fills the card (chunks of
  K sized by :func:`_split_plan`) and a second grid that sums the partials
  in chunk order and adds the adapter term; bound by bytes (W read once).
  :func:`_work_floats` sizes either body's work buffer.
* Plain version :func:`lora_matmul_plain`: the reference oracle
  ``ref.lora_matmul_ref``'s order, ``x@w + scale·((x@a)@b)`` in f32. The CPU
  path and the tests use it; nothing on the card's main path does.
* :func:`lora_matmul` is the wrapper (2-D operands): it launches the kernel
  for CUDA tensors (counting ``lora_matmul.launches``, one per call: the
  split-K body's two grids are one launch of the kernel), raises on a
  failed launch, and takes the plain version only for CPU tensors.
  :func:`lora_dense` flattens leading dims around it, as ``ops.lora_dense``.

Forward only (the reference's kernel has no VJP): an input that requires
grad is refused. f32 only: the JAX kernel also takes bf16, which is not
ported (ROADMAP).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RANK = 64       # shared memory: the tiled body keeps (128, r) x@a
SKINNY_ROWS = 16    # M at or below → the split-K body
_U = 2.0 ** -24     # f32 unit roundoff


def lora_matmul_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, scale: float) -> torch.Tensor:
    """x (M, K), w (K, N), a (K, r), b (r, N) → (M, N) f32:
    ``x@w + scale·((x@a)@b)`` (``ref.lora_matmul_ref``)."""
    x, w, a, b = x.float(), w.float(), a.float(), b.float()
    base = torch.matmul(x, w)
    adapter = torch.matmul(torch.matmul(x, a), b)
    return base + scale * adapter


def lora_matmul_error_bound(x: torch.Tensor, w: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Elementwise bound on how far two f32 evaluations of
    x@w + scale·(x@a)@b may differ when they sum in other orders (blocked or
    split K, FMA contraction).

    Each output passes through at most K + r + 4 roundings, each off by
    ≤ u = 2⁻²⁴ relative to the magnitude it carries, so either evaluation
    is within (K + r + 4)·u·M of the exact value, with
    M = |x|@|w| + |scale|·(|x|@|a|)@|b|. Two evaluations are within twice
    that (as the folds' bounds in ``fedex_residual.py``).
    """
    xa, wa, aa, ba = x.float().abs(), w.float().abs(), a.float().abs(), \
        b.float().abs()
    mag = torch.matmul(xa, wa) + abs(scale) * torch.matmul(
        torch.matmul(xa, aa), ba)
    k, r = x.shape[-1], a.shape[-1]
    return 2 * (k + r + 4) * _U * mag


def _check(x, w, a, b) -> None:
    for arg, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"lora_matmul: {arg} must be float32, got "
                            f"{t.dtype} (the bf16 variant is not ported)")
        if t.device != x.device:
            raise ValueError(f"lora_matmul: {arg} on {t.device}, x on "
                             f"{x.device}")
        if t.requires_grad:
            raise ValueError(f"lora_matmul: {arg} requires grad — the kernel "
                             "is forward only")
        if t.ndim != 2:
            raise ValueError(f"lora_matmul: {arg} must be 2-D, got "
                             f"{tuple(t.shape)}")
    (m, k), (k2, n), (k3, r), (r2, n2) = x.shape, w.shape, a.shape, b.shape
    if not (k == k2 == k3 and r == r2 and n == n2):
        raise ValueError(f"lora_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")


def _split_plan(n: int, k: int, sms: int):
    """(splits, kc) of the split-K body: K chunks of kc rows (a multiple of
    8, at most 256), halved from 256 until the grid of ⌈N/128⌉ column
    blocks × splits holds at least two blocks per SM (or kc reaches 32).
    Larger chunks cost fewer partial bytes: 2·4·splits·M·N against W's
    4·K·N."""
    col_blocks = -(-n // 128)
    kc = 256
    while kc > 32 and col_blocks * -(-k // kc) < 2 * sms:
        kc //= 2
    kc = min(kc, 8 * -(-k // 8))
    return -(-k // kc), kc


def _work_floats(m: int, n: int, r: int, splits: int) -> int:
    """Floats of the kernel's work buffer: the split-K body's partial
    products and x@a per chunk (splits·M·(N + r)), or the tiled body's x@a
    (M·r; none at r = 0)."""
    return splits * m * (n + r) if splits else m * r


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """x (M, K) @ w (K, N) + scale·(x @ a (K, r)) @ b (r, N) → a new (M, N)
    float32 tensor. Any M, N, K; r ≤ 64 on the card."""
    _check(x, w, a, b)
    if x.device.type == "cpu":
        return lora_matmul_plain(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"lora_matmul: unsupported device {x.device}")
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    if r > MAX_RANK:
        raise ValueError(f"lora_matmul: rank {r} > {MAX_RANK} (shared memory)")
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    vec = int(k % 4 == 0 and n % 4 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    splits, kc, work = 0, 0, None
    if m <= SKINNY_ROWS:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, kc = _split_plan(n, k, sms)
    nwork = _work_floats(m, n, r, splits)
    if nwork:
        work = torch.empty(nwork, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), None if work is None else work.data_ptr(),
            m, n, k, r, float(scale), splits, kc, vec, stream)
    check_launch("lora_matmul", code)
    lora_matmul.launches += 1
    return y


lora_matmul.launches = 0


def lora_dense(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, scale: float) -> torch.Tensor:
    """The fused LoRA projection for x (..., K): leading dims flattened into
    M, the result (..., N) in x's dtype (the counterpart of
    ``ops.lora_dense``; no tile-dependent branches — the kernel takes any
    shape)."""
    lead, kdim = x.shape[:-1], x.shape[-1]
    y = lora_matmul(x.reshape(math.prod(lead), kdim), w, a, b, scale)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


def lora_dense_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`lora_dense` through :func:`lora_matmul_plain` on any device
    (the plain serving path that ``chip_smoke.py`` holds the kernel path
    against on the card)."""
    lead, kdim = x.shape[:-1], x.shape[-1]
    y = lora_matmul_plain(x.reshape(math.prod(lead), kdim), w, a, b, scale)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)
