"""Flat-path ``.npz`` checkpointing of nested-dict trees.

The port's copy of ``repro/checkpoint/checkpoint.py``: a tree of tensors
(or numpy arrays) is flattened to ``path → array`` with '/'-joined keys and
stored with numpy, metadata riding along as a JSON entry. Every leaf goes
through the host; bfloat16 leaves, which numpy cannot hold, are stored as
float32 (exact) and listed under ``bf16_keys``, so they come back bfloat16.
A write goes to a temporary file in the target's directory, then replaces
the target atomically: a crash mid-save leaves the previous file whole.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.util.device import resolve_device
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

_META_KEY = "__meta__"

# one rolling round-state file per run directory: each boundary snapshot
# replaces the previous one
ROUND_STATE_FILE = "round_state.npz"


def round_state_path(directory: str) -> str:
    """The round-boundary snapshot's path inside a checkpoint directory."""
    return os.path.join(directory, ROUND_STATE_FILE)


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Write ``tree``'s leaves (tensors on any device, or array-likes) and
    the JSON-able ``meta`` to ``path``, atomically."""
    arrays, bf16 = {}, {}
    for k, v in flatten_with_paths(tree).items():
        if torch.is_tensor(v):
            if v.dtype == torch.bfloat16:
                bf16[k] = "bfloat16"
                v = v.float()
            v = v.detach().cpu().numpy()
        arrays[k] = np.asarray(v)
    if _META_KEY in arrays:
        raise ValueError(f"tree path {_META_KEY!r} is reserved")
    payload = {"meta": meta or {}, "bf16_keys": bf16}
    arrays[_META_KEY] = np.frombuffer(json.dumps(payload).encode(),
                                      dtype=np.uint8)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, device) -> Tuple[Any, Dict]:
    """``(tree, meta)`` of a :func:`save_checkpoint` file, every leaf a
    tensor on ``device`` in its saved dtype (bfloat16 restored)."""
    dev = resolve_device(device)
    flat = {}
    with np.load(path, allow_pickle=False) as z:
        payload = json.loads(z[_META_KEY].tobytes().decode())
        bf16 = payload["bf16_keys"]
        for k in z.files:
            if k == _META_KEY:
                continue
            t = torch.from_numpy(z[k]).to(dev)
            flat[k] = t.to(torch.bfloat16) if k in bf16 else t
    return unflatten_from_paths(flat), payload["meta"]
