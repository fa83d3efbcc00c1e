"""Inputs on which the bf16 kernels' roundings are exact and visible.

A bf16 kernel rounds an f32 intermediate to bf16 at one point: B3
(``lora_matmul``) rounds x@a once, after the whole K sum; B8
(``flash_swa``) rounds p before the P·V product while l sums p unrounded.
On random inputs the error bounds must allow one bf16 rounding on either
side, so a kernel that rounds elsewhere (per split-K chunk, or not at all)
stays inside them. On these inputs every sum is exact in f32, so the
kernel must equal its plain version bit for bit, and each faulty variant,
also returned, gives another answer in many elements:

* :func:`lora_probe`: x holds the integers 0..3 and a 0..15, so every
  partial sum of x@a is an integer below 2²⁴ (exact in f32) and, at any K,
  mostly not a bf16 value (above 256, bf16's last exact integer); W holds
  -1, 0 and 1; b is one-hot (output column n reads rank
  column n mod r); scale 2. The output, x@W + 2·bf16(x@a)[:, n mod r], is
  exact in f32 in any order of summation.
* :func:`swa_probe`: scores that only key 0 and one key j* < 64 of each
  (batch, KV head) survive: key 0 scores 0, the row's maximum, in the first
  KV tile of every row; key j* scores s in [-4, -0.05); every other key
  scores ≤ -128, so its p is exactly 0 (v there is random). v is 0 at key
  0, so a row at or past j* reads out bf16(p)·v[j*] / (1 + p), p = exp(s)
  in f32; q's multiplier is picked per (batch, head) so that p lies at
  least 2¹² f32 ulps from a bf16 value or a tie, so a few ulps of exp
  change no rounding.

Used by ``chip_smoke.py`` and the card tests against the kernels, and by
the CPU tests against the plain versions.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def lora_probe(m: int, k: int, n: int, r: int, *, chunk: int = 0,
               device="cpu", seed: int = 0):
    """(x, w, a, b, scale, want, faults) for ``lora_matmul`` in bf16: the
    exact output ``want`` (M, N) f32 and ``faults``, name → the output if
    x@a were not rounded, or (``chunk`` < K) rounded per ``chunk`` rows of
    K and then summed."""
    dev = torch.device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x, a, w = (torch.randint(lo, hi, shape, generator=g).to(dev, BF16)
               for lo, hi, shape in ((0, 4, (m, k)), (0, 16, (k, r)),
                                     (-1, 2, (k, n))))
    b = torch.zeros(r, n, dtype=BF16, device=dev)
    col = torch.arange(n, device=dev) % max(r, 1)
    if r:
        b[col, torch.arange(n, device=dev)] = 1
    scale = 2.0
    xf = x.double()
    base = xf @ w.double()
    xa = xf @ a.double()  # exact: integers below 2^24
    if k * 45 >= 2 ** 24:
        raise ValueError(f"lora_probe: K = {k} lets x@a leave f32's exact "
                         "integers")

    def out(t):
        return (base + scale * t[:, col] if r else base).float()

    faults = {"x@a not rounded": out(xa)}
    if 0 < chunk < k:
        parts = sum((xf[:, c:c + chunk] @ a[c:c + chunk].double())
                    .to(BF16).double() for c in range(0, k, chunk))
        faults["x@a rounded per K chunk"] = out(parts)
    return x, w, a, b, scale, out(xa.to(BF16).double()), faults


def _bf16_attention(q, k, v, causal, round_p, l_of_rounded):
    """B8's bf16 function with its two casts chosen: p rounded to bf16 (or
    not) before P·V, l summing the rounded (or the unrounded) p."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = (q.float() * d ** -0.5).reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float())
    if causal:
        seen = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~seen, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pr = p.to(BF16).float() if round_p else p
    l = torch.clamp((pr if l_of_rounded else p).sum(dim=-1), min=1e-30)
    out = torch.einsum("bkgqc,bckd->bqkgd", pr, v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, d).to(BF16)


def swa_probe(b: int, s: int, h: int, kvh: int, d: int, *, causal=True,
              sk: int = 0, device="cpu", seed: int = 0):
    """(q, k, v, faults) for ``swa_attention`` in bf16 (no window): q of
    ``s`` rows, k and v of ``sk`` (0: ``s``; a cross-attention's Sq ≠ Sk),
    Sk > 1: ``faults``, name → the output if p were not rounded, or if l
    summed the rounded p. The right output is ``swa_attention_plain``'s."""
    sk = sk or s
    g = torch.Generator(device="cpu").manual_seed(seed)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    # key j* of each (batch, KV head) in [1, min(63, Sk - 1)], its score
    # multiplier beta; every other key but 0 scores <= -128
    top = min(63, sk - 1)
    jstar = torch.randint(1, top + 1, (b, kvh), generator=g)
    beta = (-(0.05 + 1.95 * torch.rand(b, kvh, generator=g)) / scale).to(BF16)
    k = torch.zeros(b, sk, kvh, d, dtype=BF16)
    k[:, 1:, :, 0] = -2048.0
    bi, gi = torch.meshgrid(torch.arange(b), torch.arange(kvh),
                            indexing="ij")
    k[bi, jstar, gi, 0] = beta
    v = torch.randn(b, sk, kvh, d, generator=g).to(BF16)
    v[:, 0] = 0
    # q's multiplier alpha per (batch, head), from 1 + i/128, i < 128 (bf16
    # values): the first in a shuffled order whose p keeps its low 16 bits
    # in [2^12, 2^15 - 2^12] or [2^15 + 2^12, 2^16 - 2^12]
    cands = (1 + torch.arange(128) / 128).to(BF16).float()
    q = torch.zeros(b, s, h, d, dtype=BF16)
    for bb in range(b):
        for hh in range(h):
            bt = beta[bb, hh // (h // kvh)].float()
            order = cands[torch.randperm(128, generator=g)]
            p = torch.exp((order * scale) * bt)
            low = p.view(torch.int32) & 0xFFFF
            ok = ((low >= 2 ** 12) & (low <= 2 ** 15 - 2 ** 12)) | (
                (low >= 2 ** 15 + 2 ** 12) & (low <= 2 ** 16 - 2 ** 12))
            if not bool(ok.any()):
                raise ValueError("swa_probe: no multiplier keeps p off the "
                                 "bf16 grid")
            q[bb, :, hh, 0] = order[int(ok.int().argmax())]
    q, k, v = (t.to(device) for t in (q, k, v))
    return q, k, v, {
        "p not rounded": _bf16_attention(q, k, v, causal, False, False),
        "l sums the rounded p": _bf16_attention(q, k, v, causal, True, True)}


def differing(got: torch.Tensor, faults: dict) -> dict:
    """Fault name → the elements where its output differs from ``got``
    bit for bit (each must be > 0 for the probe to tell it apart)."""
    return {name: int((f.float() != got.float()).sum())
            for name, f in faults.items()}
