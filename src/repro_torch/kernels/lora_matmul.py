"""Fused LoRA projection  y = x @ W + scale · (x @ a) @ b.

Replaces the TPU kernel ``repro/kernels/lora_matmul.py::lora_matmul`` (body
``_kernel``; wrapper ``ops.lora_dense``). The serving path
(``models/attention.py``, prefill and decode) runs every adapted q/k/v/o
projection through :func:`lora_dense`: 4 launches a layer.

* CUDA kernel: ``csrc/lora_matmul.cu``, four bodies; :func:`_body` picks
  one from M, the dtype and alignment alone. bf16 operands that TMA can
  describe (K and N multiples of 8, x and W 16-byte aligned: every served
  q/k/v/o) take a tensor-core body, the tensor-core split-K one at M ≤ 16
  and the tensor-core one above; f32 and the other bf16 take the SIMT
  split-K body at M ≤ 16 and the tiled one above.

  - tensor-core (bf16, M > 16; counted in ``lora_matmul.bf16_tc_launches``):
    a small grid writes a^T padded to NA rows (:func:`_adapter_rows`) into
    the work buffer, then a persistent grid streams x, W and a^T with TMA
    into a ring of 4–5 shared-memory stages, two consumer warpgroups run
    ``wgmma`` m64n128k16 (x@W) and m64nNAk16 (x@a) with f32 accumulators,
    and a third ``wgmma`` adds scale·bf16(x@a)@b per 128 × 128 tile; bound
    by operations at prefill shapes.
  - tensor-core split-K (bf16, M ≤ 16, decode; counted in
    ``lora_matmul.bf16_tc_decode_launches``): one grid of 64-column blocks,
    a cluster of ≤ 8 K chunks each; one thread streams W with TMA (L2
    evict-first: W is read once) through a 3-stage ring, the warpgroup runs
    ``wgmma`` m64nMPk16 on W^T and x^T (MP 8 or 16), a warp computes the
    chunk's x@a on ``mma.sync``, and the chunks' partials reach the block
    that folds them by ``st.async`` into its shared memory; x's and W's
    tensor maps are cached by (pointer, shape, box); bound by bytes (W read
    once).
  - tiled (f32, and bf16 that TMA cannot describe, M > 16): a prepass grid
    writes x@a (M × r) into the work buffer, then a register-tiled SIMT
    GEMM (IEEE f32 on CUDA cores, TF32 stays off; 128 × 128 block tiles,
    K streamed in slices of 64 through a 2-stage cp.async ring in shared
    memory) adds scale·(x@a)@b in its epilogue; bound by operations at
    prefill shapes.
  - SIMT split-K (f32, and bf16 that TMA cannot describe, M ≤ 16): one
    grid; each block streams W's rows of one K chunk for bn columns
    (16-byte loads, 4 rows a thread in flight), a warp of its own computes
    the chunk's x@a, and the ≤ 8 chunks of a column block, one
    thread-block cluster, fold their partials in chunk order through
    distributed shared memory and add the adapter term; bound by bytes.

  :func:`_tc_split_plan` and :func:`_split_plan` size the split-K bodies'
  chunks and column blocks (cached per shape and SM count),
  :func:`_work_floats` the other bodies' work buffer. In the SIMT bodies
  bf16 operands are widened to f32 as they are staged, into the same
  shared memory and plan. In every body x@a is rounded to bf16 once, after
  the whole K, as the TPU kernel casts it to b's dtype.
* Plain version :func:`lora_matmul_plain`: the reference oracle
  ``ref.lora_matmul_ref``'s order, ``x@w + scale·((x@a)@b)`` in f32; with
  bf16 operands the TPU kernel's casts (x@a rounded once to b's dtype
  before the product with b; every sum in f32). The CPU path and the tests
  use it; nothing on the card's main path does.
* :func:`lora_matmul` is the wrapper (2-D operands): it launches the kernel
  for CUDA tensors (counting ``lora_matmul.launches``, one per call: the
  two grids of the tiled or the tensor-core body are one launch of it),
  raises on a failed launch, and takes the plain version only for CPU
  tensors (``lora_matmul.bf16_launches`` counts the bf16 ones among
  them). Meta tensors (the dry run) get the CUDA path's output and work
  buffer, and no launch; under :mod:`repro_torch.launch.cost`'s counter
  (``repro_torch.util.cost.LOCAL.mode``) the call counts as
  ``cost.lora_matmul_work`` on every device. Its launch path is lean,
  since decode calls it 112 times a step
  at paper-llama3.2-3b depth: the checks are one combined test, the plan
  and the SM count are cached (x's and W's tensor maps in the library),
  and no work buffer is allocated for decode.
  :func:`lora_dense` flattens leading dims around it, as ``ops.lora_dense``.

Forward only (the reference's kernel has no VJP): an input that requires
grad is refused. The operands are all float32 or all bfloat16 (the
reference's serving dtype; the output is float32 either way, as the TPU
kernel's); a mix of the two, which the JAX kernel also takes, is refused
(ROADMAP), as is any other dtype.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch.kernels.build import check_launch, load_library
from repro_torch.util import cost

MAX_RANK = 64       # shared memory: the tiled body keeps (128, r) x@a
SKINNY_ROWS = 16    # M at or below → a split-K body
TC_STAGES = 5       # K slices in the tensor-core body's ring at NA < 32 (csrc's tc_stages)
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory, at most
_U = 2.0 ** -24     # f32 unit roundoff
BF16_ULP = 2.0 ** -7  # a bf16 ulp relative to the value, at most
DTYPES = (torch.float32, torch.bfloat16)


def lora_matmul_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, scale: float) -> torch.Tensor:
    """x (M, K), w (K, N), a (K, r), b (r, N) → (M, N) f32:
    ``x@w + scale·((x@a)@b)`` (``ref.lora_matmul_ref``); for a bf16 ``b``
    x@a is rounded to bf16 first, as the TPU kernel casts it to b's
    dtype."""
    low = b.dtype == torch.bfloat16
    x, w, a, b = x.float(), w.float(), a.float(), b.float()
    base = torch.matmul(x, w)
    xa = torch.matmul(x, a)
    if low:
        xa = xa.to(torch.bfloat16).float()
    adapter = torch.matmul(xa, b)
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

    bf16 operands add one term. Their products are exact in f32, so the f32
    terms stand; but each evaluation rounds its f32 x@a (t) to bf16 once,
    off by at most half an ulp, and an ulp is at most 2⁻⁷·|t|. Two
    evaluations whose t differ in the last f32 bits may round to
    neighbouring bf16 values, so their rounded x@a differ by up to
    2·½·2⁻⁷·|t| plus the f32 difference, with |t| ≤ |x|@|a|; times |b| and
    |scale|: ``|scale|·2⁻⁷·(|x|@|a|)@|b|``.
    """
    xa, wa, aa, ba = x.float().abs(), w.float().abs(), a.float().abs(), \
        b.float().abs()
    adapter = torch.matmul(torch.matmul(xa, aa), ba)
    mag = torch.matmul(xa, wa) + abs(scale) * adapter
    k, r = x.shape[-1], a.shape[-1]
    bound = 2 * (k + r + 4) * _U * mag
    if b.dtype == torch.bfloat16:
        bound = bound + abs(scale) * BF16_ULP * adapter
    return bound


def _refuse(x, w, a, b) -> None:
    for arg, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.dtype not in DTYPES:
            raise TypeError(f"lora_matmul: {arg} must be float32 or "
                            f"bfloat16, got {t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"lora_matmul: {arg} is {t.dtype}, x is "
                            f"{x.dtype}: the operands share one dtype (a "
                            "mix is not ported)")
        if t.device != x.device:
            raise ValueError(f"lora_matmul: {arg} on {t.device}, x on "
                             f"{x.device}")
        if t.requires_grad:
            raise ValueError(f"lora_matmul: {arg} requires grad — the kernel "
                             "is forward only")
        if t.ndim != 2:
            raise ValueError(f"lora_matmul: {arg} must be 2-D, got "
                             f"{tuple(t.shape)}")


def _check(x, w, a, b) -> None:
    dev, dt = x.device, x.dtype
    if not ((dt is torch.float32 or dt is torch.bfloat16)
            and w.dtype is dt and a.dtype is dt and b.dtype is dt
            and w.device == dev and a.device == dev and b.device == dev
            and not (x.requires_grad or w.requires_grad or a.requires_grad
                     or b.requires_grad)
            and x.ndim == w.ndim == a.ndim == b.ndim == 2):
        _refuse(x, w, a, b)
    (m, k), (k2, n), (k3, r), (r2, n2) = x.shape, w.shape, a.shape, b.shape
    if not (k == k2 == k3 and r == r2 and n == n2):
        raise ValueError(f"lora_matmul: shapes disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")


MAX_SPLITS = 8      # K chunks of a column block: one portable cluster
_MIN_CHUNK = 64     # rows of a K chunk, at least


@functools.lru_cache(maxsize=256)
def _split_plan(n: int, k: int, sms: int):
    """(splits, kc, bn) of the SIMT split-K body (f32, and bf16 that TMA
    cannot describe). ``splits`` K chunks of kc rows
    (none empty), one cluster per column block of bn columns: the fewest
    chunks, a power of two up to 8 (and at most one for every 64 rows of
    K), that give a grid of ⌈N/128⌉ × splits blocks on at least half the
    ``sms`` SMs; then bn halved from 128 (to no less than 32) while the
    grid at the halved width stays within half the SMs. Each block keeps
    64 KB of W in flight, so half the SMs already stream W at the card's
    rate, and fewer, wider blocks leave fewer partials to fold. At
    K = 3072 this picks 4 × 24 blocks of 128 columns at N = 3072 and 8 × 8
    at N = 1024, the fastest plans (or within 0.1 µs of it) that
    ``chip_smoke.py --decode-sweep`` timed on an H100 80GB HBM3 at
    700 W."""
    half = max(1, sms // 2)
    most = max(1, min(MAX_SPLITS, k // _MIN_CHUNK))
    splits = 1
    while splits * 2 <= most and -(-n // 128) * splits < half:
        splits *= 2
    kc = -(-k // splits)
    bn = 128
    while bn > 32 and -(-n // (bn // 2)) * splits <= half:
        bn //= 2
    return splits, kc, bn


DC_BN = 64           # columns of a tensor-core split-K block (wgmma's M)
DC_SLICE = 64        # K rows of one TMA box of W in that body
DC_STAGES = 3        # W slices in its ring (csrc's DC_STAGES)
DC_X_BYTES = 16384   # x's staged columns, at most (csrc's DC_X_BYTES)
DC_A_BYTES = 8192    # a's staged rows, at most (csrc's DC_A_BYTES)


@functools.lru_cache(maxsize=256)
def _tc_split_plan(n: int, k: int, sms: int):
    """(splits, kc, bn) of the tensor-core split-K body: column blocks of
    bn = 64 columns (wgmma's M), then the fewest K chunks, at most 8 (one
    portable cluster) and one per 64-row slice of K, whose chunks are at
    most 1024 rows (one staging of x at M ≤ 8) and whose grid of
    ⌈N/64⌉ × splits blocks puts at least 1.4 blocks on each of the ``sms``
    SMs; kc a multiple of 64, so that no TMA box of W straddles two chunks,
    and no chunk empty. A block keeps 24 KB of W in flight and four fit an
    SM, so such a grid streams W at the card's rate with every SM busy, and
    fewer, longer chunks leave fewer partials to fold. At K = 3072 this
    picks 4 × 48 blocks at N = 3072 and 8 × 16 at N = 1024; gemma3-12b's
    3840 × 4096 takes 4 × 64, 3840 × 2048 6 × 32, 4096 × 3840 4 × 60;
    paper-gpt2's 768 × 768 6 × 12: each the fastest plan, or within 0.5 µs
    of it, that ``chip_smoke.py --decode-sweep`` timed on an H100 80GB HBM3
    at 700 W."""
    slices = max(1, -(-k // DC_SLICE))
    cols = -(-n // DC_BN)
    most = min(MAX_SPLITS, slices)
    splits = min(most, -(-slices // 16))
    while splits < most and 5 * cols * splits < 7 * sms:
        splits += 1
    kc = DC_SLICE * -(-slices // splits)
    return -(-k // kc), kc, DC_BN


def _dc_smem(mp: int, kc: int, r: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core split-K body at MP
    rows (8 or 16), chunks of kc rows and rank r (csrc's ``dc_smem``): 1 KB
    to align its base to 1024 bytes, the W ring (``DC_STAGES`` boxes of 64
    rows × 64 columns, 8 KB each), x's staged columns (at most
    ``DC_X_BYTES``: kc or fewer, a multiple of 64), a's staged rows (at
    r > 0), b's r × 64 panel (bf16), the partials of the block's share of
    the outputs from up to 8 chunks (MP × 64 + 8 f32), every chunk's x@a
    and the whole K's (9 × MP × r f32) and the mbarriers (two a stage,
    three for x and the partials)."""
    xk = min(kc, DC_X_BYTES // (2 * mp))
    return (1024 + DC_STAGES * DC_SLICE * 2 * DC_BN + xk * mp * 2
            + (DC_A_BYTES if r else 0) + r * DC_BN * 2
            + (mp * DC_BN + MAX_SPLITS) * 4 + (MAX_SPLITS + 1) * mp * r * 4
            + (2 * DC_STAGES + 3) * 8)


def _adapter_rows(r: int) -> int:
    """NA, the rank the tensor-core body pads a's columns to: the N of its
    x@a product (m64nNAk16), 0 without an adapter."""
    return 0 if r == 0 else 8 if r <= 8 else 16 if r <= 16 else \
        32 if r <= 32 else 64


def _work_floats(m: int, n: int, r: int, splits: int, tc_k: int = 0) -> int:
    """Floats of the kernel's work buffer: the tiled body's x@a (M·r; none
    at r = 0); the tensor-core body at K = ``tc_k`` a^T padded to NA rows
    (NA·K bf16, none at r = 0); the split-K body (``splits`` > 0) none."""
    if splits:
        return 0
    if tc_k:
        return -(-_adapter_rows(r) * tc_k // 2)
    return m * r


def _body(m: int, k: int, n: int, low: bool, aligned: bool) -> str:
    """The body a call takes. bf16 (``low``) operands that TMA can describe
    (K and N multiples of 8, so every row stride is a multiple of 16 bytes,
    and x and W 16-byte aligned: ``aligned``) go to the tensor cores:
    ``"tensor-core split-K"`` for M ≤ 16, ``"tensor-core"`` above. The rest
    (f32, and bf16 that TMA cannot describe) take the SIMT bodies:
    ``"split-K"`` for M ≤ 16, ``"tiled"`` above."""
    tma = low and k % 8 == 0 and n % 8 == 0 and aligned
    if m <= SKINNY_ROWS:
        return "tensor-core split-K" if tma else "split-K"
    return "tensor-core" if tma else "tiled"


def _tc_stages(na: int) -> int:
    """K slices in the tensor-core body's ring (csrc's ``tc_stages``)."""
    return 4 if na >= 32 else TC_STAGES


def _tc_smem(na: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core body at NA
    (:func:`_adapter_rows`; csrc's ``tc_smem``): 1 KB to align its base to
    the 1024 bytes over which the 128-byte swizzle repeats, the ring's
    stages of x's 128 × 64 box, W's two 64 × 64 boxes and a^T's NA × 64 box
    (bf16), the tile's x@a rows (128 rows of 128 bytes), b's panel (two
    halves of MAX_RANK rows of 128 bytes) and the mbarriers (two a stage,
    two for b's panel)."""
    stage = 2 * (128 * 64 + 2 * 64 * 64 + na * 64)
    stages = _tc_stages(na)
    return (1024 + stages * stage + 128 * 128 + 2 * MAX_RANK * 128
            + (2 * stages + 2) * 8)


_SMS = {}  # device index → SM count


def _sm_count(index: int) -> int:
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    """x (M, K) @ w (K, N) + scale·(x @ a (K, r)) @ b (r, N) → a new (M, N)
    float32 tensor; the operands all float32 or all bfloat16. Any M, N, K;
    r ≤ 64 on the card."""
    _check(x, w, a, b)
    mode = cost.LOCAL.mode
    if mode is not None and not mode.in_kernel:  # counted, then run as here
        return mode.kernel(cost.lora_matmul_work(
            x.shape[0], x.shape[1], w.shape[1], a.shape[1], x.element_size()),
            lora_matmul, x, w, a, b, scale)
    dev = x.device
    if dev.type == "cpu":
        return lora_matmul_plain(x, w, a, b, scale)
    meta = dev.type == "meta"
    if not (meta or dev.type == "cuda"):
        raise ValueError(f"lora_matmul: unsupported device {dev}")
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    if r > MAX_RANK:
        raise ValueError(f"lora_matmul: rank {r} > {MAX_RANK} (shared memory)")
    x, w, a, b = (t if t.is_contiguous() else t.contiguous()
                  for t in (x, w, a, b))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    work = None
    low = x.dtype is torch.bfloat16
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if m <= SKINNY_ROWS:
        if meta:
            return y  # the split-K bodies take no work buffer
        if _body(m, k, n, low, aligned) == "tensor-core split-K":
            splits, kc, bn = _tc_split_plan(n, k, _sm_count(dev.index))
            vec = 4  # bit 2: the tensor-core split-K body
        else:
            splits, kc, bn = _split_plan(n, k, _sm_count(dev.index))
            # bit 0: W's rows by 16-byte (f32) or 8-byte (bf16) copies; bit
            # 1 (bf16): a's rows by 8-byte copies
            vec = int(n % 4 == 0 and w.data_ptr() % (8 if low else 16) == 0)
            if low and r % 4 == 0 and a.data_ptr() % 8 == 0:
                vec |= 2
    else:
        splits = kc = bn = 0
        tc = _body(m, k, n, low, aligned) == "tensor-core"
        # bf16: the tensor-core body; f32: the tiled body's 16-byte copies
        vec = int(tc or (not low and k % 4 == 0 and n % 4 == 0 and aligned))
        if r:
            work = torch.empty(_work_floats(m, n, r, 0, k if tc else 0),
                               dtype=torch.float32, device=dev)
    if meta:
        return y
    lib = load_library()
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        code = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), None if work is None else work.data_ptr(),
            m, n, k, r, float(scale), splits, kc, bn, vec, int(low),
            torch._C._cuda_getCurrentRawStream(dev.index))
    check_launch("lora_matmul", code)
    lora_matmul.launches += 1
    if low:
        lora_matmul.bf16_launches += 1
        if vec and not splits:
            lora_matmul.bf16_tc_launches += 1
        elif vec == 4:
            lora_matmul.bf16_tc_decode_launches += 1
    return y


lora_matmul.launches = 0
lora_matmul.bf16_launches = 0  # the bf16 share of ``launches``
lora_matmul.bf16_tc_launches = 0  # the tensor-core (prefill) body's share
lora_matmul.bf16_tc_decode_launches = 0  # the tensor-core split-K body's


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
