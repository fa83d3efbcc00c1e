"""Causal / sliding-window flash attention, forward.

Replaces the TPU kernel ``repro/kernels/flash_swa.py::flash_swa`` (body
``_kernel``; wrapper ``ops.swa_attention``). The serving path's prefill
(``models/attention.py``, and ``models/mla.py`` for Multi-head Latent
Attention) runs every layer's attention through :func:`swa_attention`,
causal, with the layer's window (0 for a global layer): one launch a
layer. The served head dims are 64 (paper-gpt2), 112 (zamba2's shared
block: padded to DP 128, its second column box part past d, zero-filled
by TMA), 128 (Llama, granite, starcoder2, mixtral), 192 (deepseek-v2's
MLA: nope 128 + rope 64, v zero-padded from 128 to it; padded to DP 256,
three column boxes of four loaded) and 256 (gemma3).

* CUDA kernel: ``csrc/flash_swa.cu``, two bodies; :func:`_body` picks one
  from the dtype, the head dim, the strides and the pointers alone.

  - tensor-core (bf16 that TMA can describe: head dim and every stride a
    multiple of 8, 16-byte aligned q, k, v; every served bf16 prefill
    attention; counted in ``flash_swa.bf16_tc_launches``): one block of
    two warpgroups of 64 query rows per (batch·head, query tile), one an
    SM, at head dim > 64, and of one, four an SM, at ≤ 64 (:func:`_tc_bq`,
    :func:`_tc_blocks`, :func:`_tc_smem`); its first thread streams the Q
    tile once and K and V tiles of 128 keys at DP 128, else 64
    (:func:`_tc_bkv`), with TMA into two 2-stage rings; each warpgroup runs
    Q·Kᵀ and P·V as ``wgmma`` (bf16 in, f32 accumulators; p rounded to
    bf16 into P·V's A registers), a tile's online softmax (f32, the scale
    applied to the f32 scores) under the previous tile's P·V, and the
    output goes out by TMA. Bound by operations at 989 TFLOP/s or by bytes
    at 3.35 TB/s.
  - SIMT (f32; bf16 that TMA cannot describe, such as head dims 50 and
    66): one block of 4 warps per (batch·head, 64 query rows), two blocks
    an SM at head dim ≤ 128 and one at head dim ≤ 256 (gemma3's; the
    padded dim ``DP`` is 64, 128 or 256, and the tile and its band rules
    are the same at every DP); K/V tiles of 64 positions stream through a
    cp.async ring of two shared-memory slots (K's and V's), two block
    barriers a tile; 8 rows × 4 keys a thread for Q·Kᵀ and 8 rows × 8
    columns for P·V; online softmax with m and l per row in registers,
    IEEE f32 FMAs on CUDA cores, scale d^-½ applied to q in f32. bf16
    tiles are widened to f32 on their way into shared memory, so its
    tiles, shared memory and band rules are f32's. Bound by operations,
    4·d FLOPs per visible pair.

  In both, masked scores are −1e30 and l is clamped at 1e-30; KV tiles
  outside the causal ∩ window band are never loaded, and only tiles that
  straddle the band's edge are masked (:func:`_kv_band` and
  :func:`_interior` with each body's tile; the SIMT body's blocks of 8
  rows compute only the key groups they see, :func:`_rows_masked` and
  :func:`_key_groups`; a tensor-core warpgroup leaves out a tile past its
  rows, :func:`_tc_skips`). Rows and columns past S are masked, so any S
  runs the kernel (the reference wrapper falls back to
  ``ref.flash_swa_ref`` when S cannot be tiled; the port has no
  fallback).
* Plain versions: :func:`flash_swa_plain` is the materialised oracle
  ``ref.flash_swa_ref`` (softmax in f32); :func:`swa_attention_plain` the
  same per GQA group on (B, S, H, D). In bf16 both follow the TPU kernel's
  casts: q widened and scaled in f32 (the tensor-core body scales the
  f32 score instead), p = exp(s − row max) rounded to v's dtype before
  the PV product while l sums it unrounded, the output rounded to q's
  dtype. The CPU path and the tests use them; nothing on
  the card's main path does. :func:`swa_error_bound` states how far two
  evaluations may differ.
* :func:`flash_swa` (BH, S, D) and :func:`swa_attention` (B, S, H, D) are
  the wrappers: each launches the kernel for CUDA tensors (counting
  ``flash_swa.launches``, the bf16 ones also in ``bf16_launches`` and
  those through the tensor cores in ``bf16_tc_launches``),
  raises on a failed launch, and takes the plain version only for CPU
  tensors. Meta tensors (the dry run) get the CUDA path's output and no
  launch; under :mod:`repro_torch.launch.cost`'s counter
  (``repro_torch.util.cost.LOCAL.mode``) a call counts as
  ``cost.attention_work`` on every device. :func:`swa_attention` reads query head h's
  K/V head h // (H/KVH) in place through strides — the reference's
  ``jnp.repeat`` map with no copy of K and V.

Forward only: an input that requires grad is refused. q, k and v are all
float32 or all bfloat16 (the reference's serving dtype), the output in
their dtype (the TPU kernel's out_shape is q's); a mix, which the JAX
kernel also takes, is refused (ROADMAP), as is any other dtype. Head dim
≤ 256.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load_library
from repro_torch.util import cost

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # shared memory: one block of 64 query rows an SM
BQ = 64             # query rows of a block (the SIMT body)
BKV = 64            # keys of a KV tile (the SIMT body)
TC_ROWS = 64        # query rows of a tensor-core warpgroup
TC_STAGES = 2       # K tiles in the tensor-core body's ring, V's in theirs
SMEM_LIMIT = 232_448  # dynamic shared memory a block may take (sm_90)
DTYPES = (torch.float32, torch.bfloat16)
F32_TOL = (2e-5, 4e-5)  # (rtol, atol): two f32 evaluations, unit-scale inputs
BF16_ULP = 2.0 ** -7    # a bf16 ulp relative to the value, at most


def _smem_bytes(dp: int) -> int:
    """Dynamic shared memory of one block at padded head dim ``dp`` (64,
    128 or 256; ``smem_bytes`` in the kernel), f32: the scaled Q tile [64][dp]
    (+ 4 floats between its even and odd rows), the K and the V slot, each
    [64][dp] (+ 4 floats between its 8 row groups), and the P tile [64][64]
    (+ 16 floats between its even and odd rows)."""
    return 4 * (BQ * dp + 4 + 2 * (BKV * dp + 28) + BQ * BKV + 16)


def _tc_bq(dp: int) -> int:
    """Query rows of a tensor-core block at padded head dim ``dp``
    (``tc_bq``): two warpgroups of 64 at DP 128 and 256 (one block an SM),
    one at DP 64 (four blocks an SM)."""
    return 2 * TC_ROWS if dp > 64 else TC_ROWS


def _tc_bkv(dp: int) -> int:
    """Keys of the tensor-core body's KV tile at padded head dim ``dp``
    (``tc_bkv``): 128 at DP 128, else 64."""
    return 128 if dp == 128 else 64


def _tc_blocks(dp: int) -> int:
    """Tensor-core blocks an SM at padded head dim ``dp`` (``tc_blocks``,
    the kernel's launch bounds)."""
    return 4 if dp == 64 else 1


def _tc_smem(dp: int) -> int:
    """Dynamic shared memory of one tensor-core block at padded head dim
    ``dp`` (``tc_smem``): 1 KB to align its base to the 1024 bytes over
    which the 128-byte swizzle repeats, the Q tile [_tc_bq][dp] and
    ``TC_STAGES`` K and as many V tiles [BKV][dp], bf16, and the mbarriers
    (Q's, then a full and an empty one a stage of each ring)."""
    tile = 2 * _tc_bkv(dp) * dp
    return 1024 + 2 * _tc_bq(dp) * dp + TC_STAGES * 2 * tile \
        + (1 + 4 * TC_STAGES) * 8


# The kernel's band rules, as csrc/flash_swa.cu applies them, with each
# body's tile: the SIMT body's (BQ, BKV) = (64, 64), the tensor-core body's
# (_tc_bq, _tc_bkv) (the CPU tests hold them against the mask by brute
# force; nothing here calls them).

def _kv_band(q0: int, sq: int, sk: int, causal: bool, window: int,
             bq: int = BQ, bkv: int = BKV):
    """(lo, hi): the KV tiles of ``bkv`` keys that the query tile of ``bq``
    rows at row q0 loads, lo > hi for none. Its real rows [q0, q_last] see
    the keys [key_lo, key_hi] (``key_lo`` / ``key_hi``), every one of them
    from some row."""
    q_last = min(q0 + bq - 1, sq - 1)
    key_lo = max(0, q0 - window + 1) if window > 0 else 0
    key_hi = min(q_last, sk - 1) if causal else sk - 1
    if key_lo > key_hi:
        return 1, 0
    return key_lo // bkv, key_hi // bkv


def _interior(q0: int, q_last: int, k0: int, sk: int, causal: bool,
              window: int, bkv: int = BKV) -> bool:
    """Every pair of rows [q0, q_last] × keys [k0, k0 + bkv) is visible:
    the tile runs unmasked (``interior``; the tensor-core body asks it of
    each warpgroup's 64 rows)."""
    return (k0 + bkv <= sk and (not causal or k0 + bkv - 1 <= q0)
            and (window <= 0 or q_last - k0 < window))


def _tc_skips(r0: int, r_last: int, k0: int, sq: int, causal: bool) -> bool:
    """A tensor-core warpgroup with query rows [r0, r_last] (r_last its
    last real row) leaves a loaded KV tile at k0 out (``tc_skips``): none
    of its rows is real, or under a causal mask the tile lies past its
    last row, which has then seen its own position already."""
    return r0 >= sq or (causal and k0 > r_last)


def _rows_masked(r0: int, k0: int, sk: int, causal: bool,
                 window: int) -> bool:
    """No row of [r0, r0 + 8) sees a key of [k0, k0 + 64), k0 < sk
    (``rows_masked``)."""
    return ((causal and k0 > r0 + 7)
            or (window > 0 and r0 - min(k0 + BKV - 1, sk - 1) >= window))


def _key_groups(r0: int, k0: int, sq: int, sk: int, causal: bool,
                window: int, masked: bool, seen: bool) -> int:
    """The key groups kg + 16j, j < result, of a tile that the rows
    [r0, r0 + 8) compute (``key_groups``): none past Sq; in a masked tile
    none once the rows have all seen a key (``seen``) and see none here;
    under a causal mask not those past the last row, once the rows have
    seen a key or each sees its own position in the tile."""
    if r0 >= sq:
        return 0
    if not masked:
        return 4
    if seen and _rows_masked(r0, k0, sk, causal, window):
        return 0
    if causal and (seen or (k0 <= r0 and r0 + 7 < min(k0 + BKV, sk))):
        return min(4, (r0 + 7 - k0) // 16 + 1)
    return 4


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
    (BH, S, D) → (BH, Sq, D) f32; bf16 inputs give the bf16 kernel's
    function (:func:`swa_attention_plain`), in bf16."""
    if q.dtype == torch.bfloat16:
        return swa_attention_plain(q[:, :, None], k[:, :, None],
                                   v[:, :, None], causal, window)[:, :, 0]
    sq, d = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    s = s.masked_fill(~_mask(sq, k.shape[1], causal, window, q.device)[None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float())


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_swa_plain` per GQA group: q (B, Sq, H, D), k, v
    (B, Sk, KVH, D) → (B, Sq, H, D) in q's dtype. With bf16 inputs the TPU
    kernel's casts: q widened and scaled in f32, p = exp(s − m) (m the
    row's max) rounded to v's dtype before PV, l the sum of the unrounded
    p clamped at 1e-30, out = (p @ v) / l rounded to q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        qg = (q.float() * d ** -0.5).reshape(b, sq, kvh, h // kvh, d)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float())
        s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        out = torch.einsum("bkgqc,bckd->bqkgd", p.to(v.dtype).float(),
                           v.float())
        out = out / l.permute(0, 3, 1, 2)[..., None]
        return out.reshape(b, sq, h, d).to(q.dtype)
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * d ** -0.5
    s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def swa_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Elementwise bound (B, Sq, H, D), f32, on how far two evaluations of
    :func:`swa_attention` (q (B, Sq, H, D), k, v (B, Sk, KVH, D)) may
    differ: the kernel and its plain version, or either and the TPU kernel.

    With A = P@|v| (P the f32 softmax; A ≥ |out|): f32 inputs
    ``atol + rtol·A`` (``F32_TOL``, the reference's f32 tolerance, which
    the f32 checks state as atol + rtol·|want|). bf16 inputs add
    * P's rounding: each evaluation rounds every p to bf16, off by at most
      half an ulp ≤ 2⁻⁸·p, relative to its own running max (64-key tiles
      here, 256-key blocks in the TPU kernel, the row's max in the plain
      version); dividing by l makes it 2⁻⁸·P@|v| in each, 2·2⁻⁸·A
      between two;
    * the output's rounding: two f32 outputs that differ in the last bits
      may round to neighbouring bf16 values, one ulp ≤ 2⁻⁷·A apart.
    So ``atol + (rtol + 2⁻⁶)·A`` in bf16. q and k are exact in f32 and
    their products too; the scores' sums (the tensor cores' among them)
    and the scale round as in f32, where the single scaling of q or of the
    score is one rounding more or less: the f32 terms hold them, and the
    scores add no term of their own."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * d ** -0.5
    s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    mag = torch.einsum("bkgqc,bckd->bqkgd", p, v.float().abs())
    mag = mag.reshape(b, sq, h, d)
    rtol, atol = F32_TOL
    if q.dtype == torch.bfloat16:
        rtol += 2 * BF16_ULP
    return atol + rtol * mag


def _check(name: str, q, k, v, ndim: int) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {arg} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, q is {q.dtype}: "
                            "q, k and v share one dtype (a mix is not "
                            "ported)")
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


def _plan(name: str, b: int, h: int, d: int):
    """(padded head dim, dynamic shared memory) of a launch over ``b``
    batches of ``h`` query heads of dim ``d``; raises for a shape the
    kernel refuses."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} (shared "
                         "memory)")
    if b * h > 65535:
        raise ValueError(f"{name}: batch·heads {b * h} > 65535 (grid)")
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    return dp, _smem_bytes(dp)


def _body(low: bool, d: int, strides, sizes, aligned: bool) -> str:
    """The body a launch takes: ``"tensor-core"`` for bf16 (``low``) that
    TMA can describe — a head dim that is a multiple of 8, every stride of
    q, k and v (``strides``, the (batch, position, head) element strides
    of q, k, v and out; ``sizes`` those dimensions' lengths) a multiple of
    8 elements (16 bytes) wherever its dimension has more than one index,
    and 16-byte aligned q, k and v (``aligned``) — else ``"SIMT"`` (f32,
    odd head dims such as 50 and 66, rows or pointers off 16 bytes). Every
    served bf16 prefill attention takes the tensor cores."""
    if low and d % 8 == 0 and aligned and all(
            n == 1 or st % 8 == 0 for st, n in zip(strides[:9], sizes[:9])):
        return "tensor-core"
    return "SIMT"


def _launch(name, q, k, v, out, b, h, kvh, strides, causal, window):
    """One kernel launch; ``strides`` are the (batch, position, head)
    element strides of q, k, v and out. On the meta device: the checks,
    then ``out`` with no launch."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    sq, d, sk = q.shape[1], q.shape[-1], k.shape[1]
    dp, smem = _plan(name, b, h, d)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if q.device.type == "meta":
        return out
    low = q.dtype == torch.bfloat16
    sizes = (b, sq, h, b, sk, kvh, b, sk, kvh)
    tc = _body(low, d, strides, sizes,
               all(t.data_ptr() % 16 == 0 for t in (q, k, v))) \
        == "tensor-core"
    if tc:
        vec, smem = 2, _tc_smem(dp)
    else:
        align = 8 if low else 16  # bytes of a 4-element copy
        vec = int(d % 4 == 0 and all(s % 4 == 0 for s in strides)
                  and all(t.data_ptr() % align == 0 for t in (q, k, v, out)))
    lib = load_library()
    st = (ctypes.c_int64 * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_swa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, d, st, int(bool(causal)), int(window),
            float(d ** -0.5), vec, smem, int(low), stream)
    check_launch(name, code)
    flash_swa.launches += 1
    if low:
        flash_swa.bf16_launches += 1
        if tc:
            flash_swa.bf16_tc_launches += 1
    return out


def flash_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v (BH, S, D), all f32 or all bf16 → a new (BH, Sq, D)
    attention output in their dtype."""
    _check("flash_swa", q, k, v, 3)
    mode = cost.LOCAL.mode
    if mode is not None and not mode.in_kernel:  # counted, then run as here
        return mode.kernel(cost.attention_work(
            q.shape[0], q.shape[1], k.shape[1], 1, 1, q.shape[2], causal,
            window, q.element_size()), flash_swa, q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_swa_plain(q, k, v, causal, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(1), 0, k.stride(0), k.stride(1), 0,
               v.stride(0), v.stride(1), 0, out.stride(0), out.stride(1), 0)
    return _launch("flash_swa", q, k, v, out, q.shape[0], 1, 1, strides,
                   causal, window)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k, v (B, Sk, KVH, D), all f32 or all bf16 → a new
    (B, Sq, H, D) output in their dtype; query head h attends with K/V head
    h // (H/KVH)."""
    _check("swa_attention", q, k, v, 4)
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"swa_attention: {h} query heads over {kvh} KV heads")
    mode = cost.LOCAL.mode
    if mode is not None and not mode.in_kernel:  # counted, then run as here
        return mode.kernel(cost.attention_work(
            b, sq, k.shape[1], h, kvh, d, causal, window, q.element_size()),
            swa_attention, q, k, v, causal, window)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, causal, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    return _launch("swa_attention", q, k, v, out, b, h, kvh, strides, causal,
                   window)


flash_swa.launches = 0
flash_swa.bf16_launches = 0  # the bf16 share of ``launches``
flash_swa.bf16_tc_launches = 0  # the tensor-core body's share of those
