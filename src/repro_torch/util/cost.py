"""What the kernels and the models tell the dry run's counter.

The counter itself is :class:`repro_torch.launch.cost.CostMode`; this
module holds the part of it that the lower layers read, so that they
depend on nothing above them:

* :data:`LOCAL` — ``LOCAL.mode`` is the counter running on this thread, or
  None (a ``TorchDispatchMode`` is thread-local, so is this);
* :class:`Loop` — a model loop of identical iterations, which a counter on
  the meta device shortens (the loop-aware rule, described in
  :mod:`repro_torch.launch.cost`);
* :func:`lora_matmul_work` and :func:`attention_work` — the work that B3
  and B8 report for a call, whatever body runs it.

It imports only numpy and torch.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class _Local(threading.local):
    mode = None  # the counter running on this thread, if any


LOCAL = _Local()


class Loop:
    """``for i in Loop(n, device, first=1, last=1)`` — a model loop whose
    iterations ``first`` … ``n − last − 1`` do the same work (the first
    and last ones may differ: an empty state, a skipped update). Under a
    counter on the meta device, with at least three such iterations, it
    runs the counter's loop-aware rule; ``stack`` stacks what the loop
    appended, one entry an iteration, to its full length."""

    def __init__(self, n: int, device, first: int = 1, last: int = 1):
        self.n, self.first, self.last = n, first, last
        self.middle = n - first - last
        mode = LOCAL.mode
        self.short = (mode is not None and mode.shortcut
                      and torch.device(device).type == "meta"
                      and self.middle >= 3)

    def __iter__(self):
        if not self.short:
            yield from range(self.n)
            return
        mode, m = LOCAL.mode, self.middle
        yield from range(self.first)
        with mode.iteration(m - 1) as made:
            yield self.first                         # A
        before, mode.peak = mode.peak, mode.total
        with mode.iteration(1):
            yield self.n - self.last - 1             # B
        kept = [k for k, n in made if mode._born.get(k) == n]  # live past B
        extra = (m - 2) * sum(mode.live[k] for k in kept)
        mode.peak = max(before, mode.peak + extra)
        for k in kept:
            mode.live[k] *= m - 1
        mode.total += extra
        yield from range(self.n - self.last, self.n)

    def stack(self, entries, dim: int = 0) -> torch.Tensor:
        if self.short:
            # A's entry stands for the middle iterations that did not run:
            # detached views of it, so that no gradient sums into it
            f = self.first
            stand_in = entries[f].detach()
            entries = (list(entries[:f + 1]) + [stand_in] * (self.middle - 2)
                       + list(entries[f + 1:]))
        return torch.stack(entries, dim)


# ---- the kernels' work ----------------------------------------------------

def lora_matmul_work(m: int, k: int, n: int, r: int, elem: int):
    """(FLOPs, bytes) of B3, x (M, K) @ W (K, N) + s·(x @ a (K, r)) @ b
    (r, N): 2·M·K·N + 2·M·r·(K + N) FLOPs; x, W, a and b read once at
    ``elem`` bytes an element, the f32 y written once."""
    return (2 * m * k * n + 2 * m * r * (k + n),
            elem * (m * k + k * n + k * r + r * n) + 4 * m * n)


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal band (key ≤ query) and the
    window (query − key < window), positions from 0 on both sides."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(0, q - window + 1) if window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(b: int, sq: int, sk: int, h: int, kvh: int, d: int,
                   causal: bool, window: int, elem: int):
    """(FLOPs, bytes) of B8 over q (B, Sq, H, d) and k, v (B, Sk, KVH, d):
    4·B·H·d a visible pair (Q·Kᵀ and P·V); q, k and v read and the output
    written once at ``elem`` bytes an element."""
    return (4 * b * h * d * attention_pairs(sq, sk, causal, window),
            elem * (2 * b * sq * h * d + 2 * b * sk * kvh * d))
