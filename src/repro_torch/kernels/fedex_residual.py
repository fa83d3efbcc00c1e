"""The residual folds of the round closes, each a CUDA kernel with its plain
PyTorch version, as the reference's ``repro/kernels/fedex_residual.py``
keeps their TPU bodies side by side:

* :func:`fedex_fold` — W0 + scale·(Σ_c w_c a_c b_c − ā b̄) (fedex close);
* :func:`product_fold` — W0 + scale·Σ_c s_c a_c b_c, s signed (reinit and
  fedex_svd closes);
* :func:`product_accum` — acc ← acc + scale·Σ_c s_c a_c b_c in place (the
  chunked closes' partial fold);
* :func:`perclient_fold` — W0_c + scale·(Σ_j w_j a_j b_j − a_c b_c) per lane
  (keep_local close);
* :func:`hetero_fold` — W0_c + scale·(Σ_j w_j (a_j∘mask_j) b_j −
  (A′∘mask_c) B′) per lane (hetero close).

``fedex_fold`` replaces the TPU kernel ``repro/kernels/fedex_residual.py::
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
  (``torch.matmul`` for the rank-r products), a zero-weight lane selected
  away as the kernel leaves it unread. The CPU path and the tests use it;
  nothing on the card's main path does.
* :func:`fedex_fold` is the wrapper: it launches the kernel for CUDA tensors
  (counting ``fedex_fold.launches``), raises on a failed launch, and takes
  the plain version only for CPU tensors.

The per-lane folds below follow the same pattern (kernels
``csrc/product_fold.cu``, ``csrc/product_accum.cu``,
``csrc/perclient_fold.cu``, ``csrc/hetero_fold.cu``). Their plain versions
never multiply a masked lane or rank column by zero: they leave it out (the
reference's 0·x turns NaN into NaN), which on finite data gives the same
sums.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

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
        for i in range(c):  # a zero-weight lane is selected away, unread
            wc, live = weights[i], weights[i] != 0
            mean_prod = mean_prod + torch.where(
                live, wc * torch.matmul(a[i], b[i]), 0.0)
            abar = abar + torch.where(live, wc * a[i], 0.0)
            bbar = bbar + torch.where(live, wc * b[i], 0.0)
    residual = mean_prod - torch.matmul(abar, bbar)
    return w0.float() + scale * residual


def _check(name, w0, a, b, weights):
    for arg, t in (("w0", w0), ("a_stack", a), ("b_stack", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != w0.device:
            raise ValueError(f"{name}: {arg} on {t.device}, w0 on {w0.device}")
    if w0.ndim < 2:
        raise ValueError(f"{name}: w0 must be (m, n) or (*L, m, n), got "
                         f"{tuple(w0.shape)}")
    lead, (m, n) = tuple(w0.shape[:-2]), tuple(w0.shape[-2:])
    if a.ndim != w0.ndim + 1 or b.ndim != w0.ndim + 1:
        raise ValueError(f"{name}: a_stack / b_stack need a leading client "
                         f"axis: got {tuple(a.shape)}, {tuple(b.shape)} for "
                         f"w0 {tuple(w0.shape)}")
    c, r = a.shape[0], a.shape[-1]
    if (tuple(a.shape) != (c, *lead, m, r)
            or tuple(b.shape) != (c, *lead, r, n)):
        raise ValueError(f"{name}: shapes disagree: w0 {tuple(w0.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != (c,)
                                or weights.device != w0.device):
        raise ValueError(f"{name}: weights must be float32 ({c},) on "
                         f"{w0.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    return c, m, n, r


def _check_cuda_layout(name, w0, a, b, vectors=()):
    """What the CUDA kernels take beyond :func:`_check`: rank ≤ MAX_RANK,
    contiguous trailing (m, r) / (r, n) factor dims and contiguous W0 and
    per-lane vectors."""
    if w0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {w0.device}")
    r, n = a.shape[-1], b.shape[-1]
    if r > MAX_RANK:
        raise ValueError(f"{name}: rank {r} > {MAX_RANK} (shared memory)")
    if not w0.is_contiguous():
        raise ValueError(f"{name}: w0 must be contiguous")
    if a.stride()[-2:] != (r, 1) or b.stride()[-2:] != (n, 1):
        raise ValueError(f"{name}: the trailing (m, r) / (r, n) dims of the "
                         f"factor stacks must be contiguous (strides "
                         f"{a.stride()}, {b.stride()})")
    if any(v is not None and not v.is_contiguous() for v in vectors):
        raise ValueError(f"{name}: per-lane vectors must be contiguous")


def _out_like(name, w0, out):
    """A new output shaped like ``w0``, or ``out`` after checking it."""
    if out is None:
        return torch.empty_like(w0)
    if (out.shape != w0.shape or out.dtype != torch.float32
            or out.device != w0.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous float32 tensor "
                         "shaped like w0")
    return out


def _layer_stride(name, t, layers):
    """The stride of one flattened layer axis over the stacked axes of
    ``t`` (lead, *L, x, y): they must nest, as in a view."""
    try:
        return t.view(t.shape[0], layers, *t.shape[-2:]).stride(1)
    except RuntimeError:
        raise ValueError(f"{name}: the stacked layer axes of a "
                         f"{tuple(t.shape)} tensor with strides {t.stride()} "
                         "do not flatten into one") from None


def _layer_strides(w0, a, b, name):
    """(layers, a's layer stride, b's layer stride): w0's stacked axes *L
    (gemma3's (nper, ratio) too) taken as one layer axis, in row-major
    order; 1 layer for a 2-D w0. W0 itself is contiguous."""
    if w0.ndim == 2:
        return 1, 0, 0
    layers = math.prod(w0.shape[:-2])
    return (layers, _layer_stride(name, a, layers),
            _layer_stride(name, b, layers))


def fedex_fold(w0: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
               scale: float, *, weights: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W0 + scale·ΔW_res for w0 (m, n) or (*L, m, n), client-leading
    a_stack (C, [*L,] m, r) and b_stack (C, [*L,] r, n), float32.

    ``weights`` — optional (C,) normalised weights (zeros mask lanes);
    ``None`` → the uniform body. ``out`` may be ``w0`` itself (in-place
    fold); by default a new tensor is returned.
    """
    c, m, n, r = _check("fedex_fold", w0, a_stack, b_stack, weights)
    if w0.device.type == "cpu":
        res = fedex_fold_plain(w0, a_stack, b_stack, scale, weights)
        return res if out is None else out.copy_(res)
    _check_cuda_layout("fedex_fold", w0, a_stack, b_stack, (weights,))
    out = _out_like("fedex_fold", w0, out)
    layers, sa_l, sb_l = _layer_strides(w0, a_stack, b_stack, "fedex_fold")
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


# --------------------------------------------------------------------------
# shared by the per-lane folds
# --------------------------------------------------------------------------

U = 2.0 ** -24  # f32 unit roundoff


def _live(coeffs: torch.Tensor) -> List[int]:
    """Lanes whose coefficient is not exactly zero (one host sync)."""
    return torch.nonzero(coeffs != 0).flatten().tolist()


def _lane_ranks(ranks: torch.Tensor, r: int) -> List[int]:
    """Live rank columns per lane: −1 means all r, others clip to r."""
    return [r if k < 0 else min(k, r) for k in ranks.tolist()]


def _product_sum(a: torch.Tensor, b: torch.Tensor, coeffs: torch.Tensor,
                 ks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Σ_j c_j·(a_j[…, :k_j] @ b_j[…, :k_j, :]) in lane order, from zero,
    over the lanes with c_j ≠ 0 and k_j > 0; no other lane is read."""
    acc = torch.zeros(a.shape[1:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    for j in _live(coeffs):
        k = a.shape[-1] if ks is None else ks[j]
        if k:
            acc = acc + coeffs[j] * torch.matmul(a[j][..., :k],
                                                 b[j][..., :k, :])
    return acc


def _lanes_of(name: str, w0_lanes, a, b, weights):
    """Check a per-lane fold's inputs; returns (lanes, c, m, n, r)."""
    lanes = list(w0_lanes)
    if len(lanes) != a.shape[0]:
        raise ValueError(f"{name}: {len(lanes)} W0 lanes for a stack of "
                         f"{a.shape[0]} clients")
    produced = [t for t in lanes if t is not None]
    if not produced:
        raise ValueError(f"{name}: no lane to produce")
    ref = produced[0]
    c, m, n, r = _check(name, ref, a, b, weights)
    for t in produced:
        if (t.shape != ref.shape or t.dtype != torch.float32
                or t.device != ref.device):
            raise ValueError(f"{name}: every W0 lane must be float32 "
                             f"{tuple(ref.shape)} on {ref.device}")
    return lanes, c, m, n, r


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_outs(name: str, lanes, out):
    """The output lanes: new tensors, or ``out`` after checking that lane c
    writes only its own storage (it may be lane c's W0 itself)."""
    if out is None:
        return [None if t is None else torch.empty_like(t) for t in lanes]
    out = list(out)
    if len(out) != len(lanes) or any((o is None) != (t is None)
                                     for o, t in zip(out, lanes)):
        raise ValueError(f"{name}: out must give one tensor for each "
                         "produced lane and None elsewhere")
    for c, o in enumerate(out):
        if o is None:
            continue
        _out_like(name, lanes[c], o)
        lo, hi = _span(o)
        for d, other in enumerate(lanes):
            for t in (other, out[d]) if d != c else ():
                if t is not None:
                    tlo, thi = _span(t)
                    if lo < thi and tlo < hi:
                        raise ValueError(f"{name}: output lane {c} overlaps "
                                         f"the storage of lane {d}")
        if o.data_ptr() != lanes[c].data_ptr():
            tlo, thi = _span(lanes[c])
            if lo < thi and tlo < hi:
                raise ValueError(f"{name}: output lane {c} partly overlaps "
                                 "its own W0")
    return out


def _lane_pointers(lanes, device) -> torch.Tensor:
    """(2, C) int64 device array: W0 and output lane pointers (0 = none).
    Freeing it right after the launch is safe: the caching allocator hands
    its block out again only to work queued behind the kernel on the same
    stream."""
    return torch.tensor([[0 if t is None else t.data_ptr() for t in row]
                         for row in lanes], dtype=torch.int64, device=device)


def _finish(res, out):
    """Plain-version results into ``out`` (or as they are)."""
    if out is None:
        return res
    for o, x in zip(out, res):
        if o is not None:
            o.copy_(x)
    return out


# --------------------------------------------------------------------------
# signed product fold (reinit, fedex_svd): W0 + scale·Σ_c s_c a_c b_c
# --------------------------------------------------------------------------

def product_fold_plain(w0: torch.Tensor, a_stack: torch.Tensor,
                       b_stack: torch.Tensor, signs: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """w0 (*L, m, n), a (C, *L, m, r), b (C, *L, r, n), signs (C,) →
    (*L, m, n) f32; lanes with s_c = 0 are not read."""
    acc = _product_sum(a_stack.float(), b_stack.float(), signs)
    return w0.float() + scale * acc


def product_fold(w0: torch.Tensor, a_stack: torch.Tensor,
                 b_stack: torch.Tensor, signs: torch.Tensor, scale: float, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W0 + scale·Σ_c s_c·a_c b_c for w0 (m, n) or (*L, m, n), client-leading
    a_stack (C, [*L,] m, r) and b_stack (C, [*L,] r, n), a signed (C,) float32
    ``signs`` (zeros mask lanes), all float32. Replaces the TPU kernel
    ``product_fold_apply`` (CUDA: ``csrc/product_fold.cu``). ``out`` may be
    ``w0`` itself (in-place fold)."""
    c, m, n, r = _check("product_fold", w0, a_stack, b_stack, signs)
    if w0.device.type == "cpu":
        res = product_fold_plain(w0, a_stack, b_stack, signs, scale)
        return res if out is None else out.copy_(res)
    _check_cuda_layout("product_fold", w0, a_stack, b_stack, (signs,))
    out = _out_like("product_fold", w0, out)
    layers, sa_l, sb_l = _layer_strides(w0, a_stack, b_stack,
                                        "product_fold")
    lib = load_library()
    with torch.cuda.device(w0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.product_fold_launch(
            w0.data_ptr(), out.data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), signs.data_ptr(), c, layers, m, n, r,
            a_stack.stride(0), sa_l, b_stack.stride(0), sb_l, float(scale),
            stream)
    check_launch("product_fold", code)
    product_fold.launches += 1
    return out


product_fold.launches = 0


def product_error_bound(w0: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, signs: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Elementwise bound on how far two f32 evaluations of the product fold
    may differ: each passes through at most C + r + 4 roundings of ≤ u
    relative to M = |W0| + |scale|·Σ_c |s_c| |a_c| |b_c|, so two are within
    2·(C + r + 4)·u·M (as :func:`fold_error_bound`)."""
    c, r = a_stack.shape[0], a_stack.shape[-1]
    mag = w0.float().abs() + abs(scale) * _product_sum(
        a_stack.float().abs(), b_stack.float().abs(), signs.abs())
    return 2 * (c + r + 4) * U * mag


# --------------------------------------------------------------------------
# accumulating product fold (chunked closes): acc += scale·Σ_c s_c a_c b_c
# --------------------------------------------------------------------------

def product_accum_plain(acc: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, signs: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """acc + scale·Σ_c s_c a_c b_c as a new tensor: the lanes summed in slot
    order first, the sum then added to acc; lanes with s_c = 0 are not
    read. The function of :func:`product_fold_plain` with acc as W0."""
    return product_fold_plain(acc, a_stack, b_stack, signs, scale)


def _extent(t: torch.Tensor):
    """[first, last + 1) byte addresses a (possibly strided) tensor spans."""
    start = t.data_ptr()
    if t.numel() == 0:
        return start, start
    last = sum((size - 1) * stride
               for size, stride in zip(t.shape, t.stride()))
    return start, start + (last + 1) * t.element_size()


def product_accum(acc: torch.Tensor, a_stack: torch.Tensor,
                  b_stack: torch.Tensor, signs: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """acc ← acc + scale·Σ_c s_c·a_c b_c IN PLACE, and returns acc: the
    chunked close's partial fold of one chunk into its product accumulator.
    acc is (m, n) or (*L, m, n), float32 and contiguous, and shares no
    storage with the client-leading a_stack (C, [*L,] m, r) / b_stack
    (C, [*L,] r, n); ``signs`` is a (C,) float32 vector (zeros mask lanes,
    which are never read). Replaces the TPU kernel ``product_accum_apply``
    (CUDA: ``csrc/product_accum.cu``, bitwise equal to
    :func:`product_fold` with ``out=acc``)."""
    name = "product_accum"
    c, m, n, r = _check(name, acc, a_stack, b_stack, signs)
    if not acc.is_contiguous():
        raise ValueError(f"{name}: acc must be contiguous")
    lo, hi = _extent(acc)
    for arg, t in (("a_stack", a_stack), ("b_stack", b_stack)):
        tlo, thi = _extent(t)
        if lo < thi and tlo < hi:
            raise ValueError(f"{name}: acc overlaps the storage of {arg}")
    if acc.device.type == "cpu":
        return acc.copy_(product_accum_plain(acc, a_stack, b_stack, signs,
                                             scale))
    _check_cuda_layout(name, acc, a_stack, b_stack, (signs,))
    layers, sa_l, sb_l = _layer_strides(acc, a_stack, b_stack, name)
    lib = load_library()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.product_accum_launch(
            acc.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
            signs.data_ptr(), c, layers, m, n, r, a_stack.stride(0), sa_l,
            b_stack.stride(0), sb_l, float(scale), stream)
    check_launch(name, code)
    product_accum.launches += 1
    return acc


product_accum.launches = 0


def product_accum_error_bound(acc: torch.Tensor, a_stack: torch.Tensor,
                              b_stack: torch.Tensor, signs: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Elementwise bound on how far two f32 evaluations of one partial fold
    may differ: :func:`product_error_bound` with acc as W0,
    2·(C + r + 4)·u·(|acc| + |scale|·Σ_c |s_c| |a_c| |b_c|)."""
    return product_error_bound(acc, a_stack, b_stack, signs, scale)


# --------------------------------------------------------------------------
# per-client fold (keep_local): W0_c + scale·(Σ_j w_j a_j b_j − a_c b_c)
# --------------------------------------------------------------------------

def perclient_fold_plain(w0_lanes: Sequence[Optional[torch.Tensor]],
                         a_stack: torch.Tensor, b_stack: torch.Tensor,
                         weights: torch.Tensor, scale: float
                         ) -> List[Optional[torch.Tensor]]:
    """Lane c (where ``w0_lanes[c]`` is not None) → W0_c + scale·(ideal −
    a_c b_c), ideal = Σ_j w_j a_j b_j over the lanes with w_j ≠ 0."""
    a, b = a_stack.float(), b_stack.float()
    ideal = _product_sum(a, b, weights)
    return [None if w0 is None else
            w0.float() + scale * (ideal - torch.matmul(a[c], b[c]))
            for c, w0 in enumerate(w0_lanes)]


def perclient_fold(w0_lanes: Sequence[Optional[torch.Tensor]],
                   a_stack: torch.Tensor, b_stack: torch.Tensor,
                   weights: torch.Tensor, scale: float, *,
                   out: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> List[Optional[torch.Tensor]]:
    """The keep_local fold of every produced lane in one pass. ``w0_lanes``
    holds C entries: lane c's own (m, n) or (*L, m, n) float32 W0, or None
    for a lane not produced (its output is None too). a_stack (C, [*L,] m, r)
    and b_stack (C, [*L,] r, n) are client-leading; ``weights`` (C,) float32
    (zeros mask lanes). ``out`` may give each lane's own W0 (in-place fold
    into every delivered client's base); lanes must not share storage.
    Replaces the TPU kernel ``perclient_fold_apply`` (CUDA:
    ``csrc/perclient_fold.cu``)."""
    lanes, c, m, n, r = _lanes_of("perclient_fold", w0_lanes, a_stack,
                                  b_stack, weights)
    outs = _check_outs("perclient_fold", lanes, out)
    ref = next(t for t in lanes if t is not None)
    if ref.device.type == "cpu":
        res = perclient_fold_plain(lanes, a_stack, b_stack, weights, scale)
        return _finish(res, outs if out is not None else None)
    _check_cuda_layout("perclient_fold", ref, a_stack, b_stack, (weights,))
    if any(t is not None and not t.is_contiguous() for t in lanes):
        raise ValueError("perclient_fold: W0 lanes must be contiguous")
    ptrs = _lane_pointers((lanes, outs), ref.device)
    layers, sa_l, sb_l = _layer_strides(ref, a_stack, b_stack,
                                        "perclient_fold")
    lib = load_library()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.perclient_fold_launch(
            ptrs[0].data_ptr(), ptrs[1].data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), weights.data_ptr(), c, layers, m, n, r,
            a_stack.stride(0), sa_l, b_stack.stride(0), sb_l, float(scale),
            stream)
    check_launch("perclient_fold", code)
    perclient_fold.launches += 1
    return outs


perclient_fold.launches = 0


def perclient_error_bound(w0_lanes: Sequence[Optional[torch.Tensor]],
                          a_stack: torch.Tensor, b_stack: torch.Tensor,
                          weights: torch.Tensor, scale: float
                          ) -> List[Optional[torch.Tensor]]:
    """Per produced lane: 2·(C + r + 4)·u·(|W0_c| + |scale|·(Σ_j |w_j|
    |a_j| |b_j| + |a_c| |b_c|))."""
    a, b = a_stack.float().abs(), b_stack.float().abs()
    c, r = a.shape[0], a.shape[-1]
    ideal = _product_sum(a, b, weights.abs())
    return [None if w0 is None else 2 * (c + r + 4) * U * (
        w0.float().abs() + abs(scale) * (ideal + torch.matmul(a[i], b[i])))
        for i, w0 in enumerate(w0_lanes)]


# --------------------------------------------------------------------------
# hetero fold: W0_c + scale·(Σ_j w_j (a_j∘mask_j) b_j − (A′∘mask_c) B′)
# --------------------------------------------------------------------------

def hetero_fold_plain(w0_lanes: Sequence[Optional[torch.Tensor]],
                      a_stack: torch.Tensor, b_stack: torch.Tensor,
                      weights: torch.Tensor, ranks: torch.Tensor,
                      own_a: torch.Tensor, own_b: torch.Tensor, scale: float
                      ) -> List[Optional[torch.Tensor]]:
    """Lane c → W0_c + scale·(ideal − A′[…, :k_c] B′[…, :k_c, :]), ideal =
    Σ_j w_j a_j[…, :k_j] b_j[…, :k_j, :], k_c = r for rank −1 else
    min(rank_c, r). Masked rank columns and lanes with w_j = 0 or k_j = 0
    are not read (slicing, where the reference multiplies by 0/1 masks)."""
    a, b = a_stack.float(), b_stack.float()
    ks = _lane_ranks(ranks, a.shape[-1])
    ideal = _product_sum(a, b, weights, ks)
    oa, ob = own_a.float(), own_b.float()
    return [None if w0 is None else w0.float() + scale * (
        ideal - torch.matmul(oa[..., :ks[c]], ob[..., :ks[c], :]))
        for c, w0 in enumerate(w0_lanes)]


def hetero_fold(w0_lanes: Sequence[Optional[torch.Tensor]],
                a_stack: torch.Tensor, b_stack: torch.Tensor,
                weights: torch.Tensor, ranks: torch.Tensor,
                own_a: torch.Tensor, own_b: torch.Tensor, scale: float, *,
                out: Optional[Sequence[Optional[torch.Tensor]]] = None
                ) -> List[Optional[torch.Tensor]]:
    """The hetero fold of every produced lane in one pass. Lanes, stacks,
    ``weights`` and ``out`` as :func:`perclient_fold`; ``ranks`` is the (C,)
    int32 true-rank vector (−1 = full rank, 0 masks a lane), and ``own_a``
    ([*L,] m, r) / ``own_b`` ([*L,] r, n) the shared rank-r truncation factors
    each lane masks down to its own rank. Replaces the TPU kernel
    ``hetero_fold_apply`` (CUDA: ``csrc/hetero_fold.cu``)."""
    name = "hetero_fold"
    lanes, c, m, n, r = _lanes_of(name, w0_lanes, a_stack, b_stack, weights)
    ref = next(t for t in lanes if t is not None)
    if ranks.dtype != torch.int32 or ranks.shape != (c,) \
            or ranks.device != ref.device:
        raise ValueError(f"{name}: ranks must be int32 ({c},) on "
                         f"{ref.device}, got {ranks.dtype} "
                         f"{tuple(ranks.shape)} on {ranks.device}")
    lead = tuple(ref.shape[:-2])
    if (own_a.dtype != torch.float32 or own_b.dtype != torch.float32
            or tuple(own_a.shape) != (*lead, m, r)
            or tuple(own_b.shape) != (*lead, r, n)
            or own_a.device != ref.device or own_b.device != ref.device):
        raise ValueError(f"{name}: own_a / own_b must be float32 "
                         f"{(*lead, m, r)} / {(*lead, r, n)} on {ref.device}")
    outs = _check_outs(name, lanes, out)
    if ref.device.type == "cpu":
        res = hetero_fold_plain(lanes, a_stack, b_stack, weights, ranks,
                                own_a, own_b, scale)
        return _finish(res, outs if out is not None else None)
    _check_cuda_layout(name, ref, a_stack, b_stack, (weights, ranks))
    if (any(t is not None and not t.is_contiguous() for t in lanes)
            or own_a.stride()[-2:] != (r, 1)
            or own_b.stride()[-2:] != (n, 1)):
        raise ValueError(f"{name}: W0 lanes and the trailing dims of own_a / "
                         "own_b must be contiguous")
    ptrs = _lane_pointers((lanes, outs), ref.device)
    layers, sa_l, sb_l = _layer_strides(ref, a_stack, b_stack, name)
    so_a = so_b = 0
    if ref.ndim > 2:  # own_a / own_b: (*L, m, r) / (*L, r, n)
        so_a = _layer_stride(name, own_a[None], layers)
        so_b = _layer_stride(name, own_b[None], layers)
    lib = load_library()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.hetero_fold_launch(
            ptrs[0].data_ptr(), ptrs[1].data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), weights.data_ptr(), ranks.data_ptr(),
            own_a.data_ptr(), own_b.data_ptr(), c, layers, m, n, r,
            a_stack.stride(0), sa_l, b_stack.stride(0), sb_l, so_a, so_b,
            float(scale), stream)
    check_launch(name, code)
    hetero_fold.launches += 1
    return outs


hetero_fold.launches = 0


def hetero_error_bound(w0_lanes: Sequence[Optional[torch.Tensor]],
                       a_stack: torch.Tensor, b_stack: torch.Tensor,
                       weights: torch.Tensor, ranks: torch.Tensor,
                       own_a: torch.Tensor, own_b: torch.Tensor, scale: float
                       ) -> List[Optional[torch.Tensor]]:
    """Per produced lane: 2·(C + r + 4)·u·(|W0_c| + |scale|·(Σ_j |w_j|
    |a_j∘mask_j| |b_j∘mask_j| + |A′∘mask_c| |B′|)), masked columns unread."""
    a, b = a_stack.float().abs(), b_stack.float().abs()
    c, r = a.shape[0], a.shape[-1]
    ks = _lane_ranks(ranks, r)
    ideal = _product_sum(a, b, weights.abs(), ks)
    oa, ob = own_a.float().abs(), own_b.float().abs()
    return [None if w0 is None else 2 * (c + r + 4) * U * (
        w0.float().abs() + abs(scale) * (
            ideal + torch.matmul(oa[..., :ks[i]], ob[..., :ks[i], :])))
        for i, w0 in enumerate(w0_lanes)]
