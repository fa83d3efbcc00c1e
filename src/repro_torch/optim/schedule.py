"""LR schedules: constant / linear / cosine with warmup (paper Appendix B).

Counterpart of ``repro/optim/schedule.py``, computed in float32 as the
reference computes it; returns a Python float.
"""

from __future__ import annotations

import math

import numpy as np


def lr_at(step, *, base_lr: float, total_steps: int, warmup_ratio: float = 0.02,
          kind: str = "cosine", min_ratio: float = 0.0) -> float:
    f32 = np.float32
    step = f32(step)
    warmup = max(f32(1.0), f32(warmup_ratio * total_steps))
    warm = f32(step / warmup)
    frac = f32(np.clip(f32(step - warmup) / max(f32(1.0),
                                                f32(total_steps - warmup)),
                       0.0, 1.0))
    if kind == "cosine":
        decay = f32(min_ratio + (1 - min_ratio) * 0.5
                    * (1 + np.cos(f32(math.pi) * frac, dtype=f32)))
    elif kind == "linear":
        decay = f32(min_ratio + (1 - min_ratio) * (f32(1.0) - frac))
    elif kind == "constant":
        decay = f32(1.0)
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    return float(f32(base_lr) * (warm if step < warmup else decay))
