"""Weighted LoRA factor mean  x̄ = Σ_c w_c · x_c  over a stacked client axis.

Replaces the TPU kernel ``repro/kernels/factor_mean.py::lora_factor_mean``
(bodies ``_kernel`` / ``_kernel_weighted``; wrapper ``ops.factor_mean``).
The round-close engine reduces the engine's ``(C_max, L, m, n)`` factor
stacks to the global factors ā and b̄ with it: one grouped launch for the a
and b stacks of every adapted leaf of a close, or of a chunk fold.

* CUDA kernel: ``csrc/factor_mean.cu``. One launch reduces a group of
  stacks that share C and the weights; the group's table rides in the
  kernel's parameters (at most :data:`MAX_GROUP` tensors a launch, see
  :func:`_group_plan`), a block takes 1024 outputs of one tensor, a thread
  a float4 of them. Bound on the card: bytes, (C_live + 1)·count·4 — at the
  engine's factor sizes (~2.3 M outputs a close at paper-llama3.2-3b width)
  a close moves ~27 MB, so the launch path is what the wrapper keeps lean.
  A zero-weight lane is never read (adds exactly 0).
* Plain version :func:`factor_mean_plain`: the same arithmetic in PyTorch
  ops (slot-order sum; the kernel rounds every product and sum like separate
  PyTorch ops, so the two agree bitwise on finite inputs). The CPU path and
  the tests use it; nothing on the card's main path does. Like the kernel
  it never reads a zero-weight lane: the lane's term is selected away
  (the reference's 0·x would turn a NaN in an unwritten lane into NaN).
* :func:`factor_mean_group` is the wrapper: it launches the kernel for CUDA
  tensors (counting ``factor_mean.launches``, one per grouped launch),
  raises on a failed launch, and takes the plain version only for CPU
  tensors. :func:`factor_mean` is its one-tensor case.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_GROUP = 32         # tensors a launch: the kernel's parameter table
OUTPUTS_PER_BLOCK = 1024
_MAX_GRID = 2 ** 31 - 1


def factor_mean_plain(stack: torch.Tensor,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, *dims) → (*dims) f32: Σ_c w_c x_c, or with ``weights=None`` the
    slot-order sum divided by C (an IEEE division on every device: C goes
    as a tensor on x's device, since a Python-number divisor makes
    PyTorch's CUDA kernel multiply by 1/C, which can differ from x / C in
    the last bit when C is not a power of two)."""
    x = stack.float()
    c = x.shape[0]
    if weights is None:
        acc = x[0]
        for i in range(1, c):
            acc = acc + x[i]
        return acc / torch.tensor(float(c), device=x.device)
    acc = torch.zeros_like(x[0])
    for i in range(c):
        acc = acc + torch.where(weights[i] != 0, weights[i] * x[i], 0.0)
    return acc


def _lane_contiguous(stack: torch.Tensor) -> bool:
    """Each client lane ``stack[c]`` is one contiguous block (the lane
    stride itself is free)."""
    if stack.is_contiguous():
        return True
    expect = 1
    for size, stride in zip(reversed(stack.shape[1:]),
                            reversed(stack.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _refuse(stacks: Sequence[torch.Tensor], weights: Optional[torch.Tensor],
            out: Optional[Sequence[torch.Tensor]]) -> None:
    """Raise on what :func:`_check` found wrong, with the reason."""
    if not stacks:
        raise ValueError("factor_mean: empty group")
    first = stacks[0]
    for stack in stacks:
        if stack.dtype != torch.float32:
            raise TypeError(f"factor_mean: stack must be float32, got "
                            f"{stack.dtype}")
        if stack.ndim < 2 or stack.shape[0] < 1:
            raise ValueError(f"factor_mean: need a (C, ...) stack, got "
                             f"{tuple(stack.shape)}")
        if stack.shape[0] != first.shape[0] or stack.device != first.device:
            raise ValueError("factor_mean: a group shares C and the device "
                             f"({tuple(stack.shape)} on {stack.device} vs "
                             f"{tuple(first.shape)} on {first.device})")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != first.shape[:1]
                                or weights.device != first.device):
        raise ValueError(
            f"factor_mean: weights must be float32 of shape "
            f"({first.shape[0]},) on {first.device}, got {weights.dtype} "
            f"{tuple(weights.shape)} on {weights.device}")
    if out is not None:
        if len(out) != len(stacks):
            raise ValueError(f"factor_mean: {len(out)} outputs for "
                             f"{len(stacks)} stacks")
        for o, stack in zip(out, stacks):
            if (o.dtype != torch.float32 or o.shape != stack.shape[1:]
                    or o.device != first.device):
                raise ValueError(f"factor_mean: out {o.dtype} "
                                 f"{tuple(o.shape)} on {o.device} for a "
                                 f"stack {tuple(stack.shape)}")
    raise ValueError("factor_mean: the group's stacks, weights or outputs "
                     "do not fit together")


def _check(stacks: Sequence[torch.Tensor], weights: Optional[torch.Tensor],
           out: Optional[Sequence[torch.Tensor]]) -> None:
    """One pass over the group (the launch path runs it once a group)."""
    f32 = torch.float32
    ok = bool(stacks) and stacks[0].ndim >= 2 and stacks[0].shape[0] >= 1
    if ok:
        c, dev = stacks[0].shape[0], stacks[0].get_device()
        for stack in stacks:
            if (stack.dtype != f32 or stack.ndim < 2 or stack.shape[0] != c
                    or stack.get_device() != dev):
                ok = False
                break
        if weights is not None:
            ok = ok and (weights.dtype == f32 and weights.ndim == 1
                         and weights.shape[0] == c
                         and weights.get_device() == dev)
        if out is not None:
            ok = ok and len(out) == len(stacks) and all(
                o.dtype == f32 and o.shape == s.shape[1:]
                and o.get_device() == dev for o, s in zip(out, stacks))
    if not ok:
        _refuse(stacks, weights, out)


def _group_plan(entries: Sequence[tuple]) -> List[List[tuple]]:
    """Launches of a group. ``entries`` are (source pointer, destination
    pointer, count, lane stride) per tensor; returns one list per launch of
    (source, destination, count, lane stride, first block, 16-byte flag):
    at most :data:`MAX_GROUP` tensors and a grid of at most 2³¹ − 1 blocks
    a launch, first blocks the prefix sum of ⌈count / 1024⌉ from 0 in each,
    and the flag set where count, lane stride and both pointers are
    multiples of 4 floats (16 bytes)."""
    launches, cur, blocks = [], [], 0
    for src, dst, count, stride in entries:
        need = -(-count // OUTPUTS_PER_BLOCK)
        if cur and (len(cur) == MAX_GROUP or blocks + need > _MAX_GRID):
            launches.append(cur)
            cur, blocks = [], 0
        if need > _MAX_GRID:
            raise ValueError(f"factor_mean: {count} outputs exceed one grid")
        cur.append((src, dst, count, stride, blocks,
                    int(not ((src | dst) & 15 or (count | stride) & 3))))
        blocks += need
    if cur:
        launches.append(cur)
    return launches


def _new_outputs(stacks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One new float32 tensor per stack, shaped like a lane: stacks whose
    lanes share a shape share one allocation, unbound into its rows (one
    allocation and one call for e.g. the a factors of all leaves)."""
    shapes = {}
    for i, stack in enumerate(stacks):
        shapes.setdefault(stack.shape[1:], []).append(i)
    out = [None] * len(stacks)
    dev = stacks[0].device
    for shape, idx in shapes.items():
        rows = torch.empty((len(idx), *shape), dtype=torch.float32,
                           device=dev).unbind(0)
        for i, t in zip(idx, rows):
            out[i] = t
    return out


def factor_mean_group(stacks: Sequence[torch.Tensor],
                      weights: Optional[torch.Tensor] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      accumulate: bool = False) -> List[torch.Tensor]:
    """Σ_c w_c·x_c over the leading client axis of each stack (C, *dims) of
    a group that shares C, the device and ``weights``.

    ``weights`` — optional (C,) float32 normalised weights on the stacks'
    device (zeros mask lanes); ``None`` → uniform slot-order mean. ``out`` —
    optional float32 (*dims) tensors, one per stack, written in place; with
    ``accumulate`` each becomes out + mean (one rounding after the mean,
    as ``out.add_(mean)``), which needs ``out``. Returns the outputs.
    """
    _check(stacks, weights, out)
    if accumulate and out is None:
        raise ValueError("factor_mean: accumulate needs out")
    dev = stacks[0].device
    if dev.type == "cpu":
        means = [factor_mean_plain(s, weights) for s in stacks]
        if out is None:
            return means
        for o, m in zip(out, means):
            if accumulate:
                o.add_(m)
            else:
                o.copy_(m)
        return list(out)
    if dev.type != "cuda":
        raise ValueError(f"factor_mean: unsupported device {dev}")
    for stack in stacks:
        if not _lane_contiguous(stack):
            raise ValueError("factor_mean: each client lane must be "
                             f"contiguous (strides {stack.stride()})")
    if out is None:
        out = _new_outputs(stacks)
    elif not all(o.is_contiguous() for o in out):
        raise ValueError("factor_mean: out must be contiguous")
    if weights is not None and not weights.is_contiguous():
        raise ValueError("factor_mean: weights must be contiguous")
    entries = [(s.data_ptr(), o.data_ptr(), n, s.stride(0))
               for s, o in zip(stacks, out) if (n := o.numel())]
    lib = load_library()
    wptr = None if weights is None else weights.data_ptr()
    c = stacks[0].shape[0]
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        for plan in _group_plan(entries):
            table = (ctypes.c_int64 * (6 * len(plan)))(
                *itertools.chain.from_iterable(plan))
            code = lib.factor_mean_launch(table, len(plan), wptr, c,
                                          int(accumulate), stream)
            check_launch("factor_mean", code)
            factor_mean.launches += 1
    return list(out)


def factor_mean(stack: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_c w_c·x_c over the leading client axis of ``stack`` (C, *dims): the
    one-tensor case of :func:`factor_mean_group`.

    ``weights`` — optional (C,) float32 normalised weights on the stack's
    device (zeros mask lanes); ``None`` → uniform slot-order mean. Returns a
    new (*dims) float32 tensor.
    """
    return factor_mean_group([stack], weights)[0]


factor_mean.launches = 0
