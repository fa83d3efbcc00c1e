"""Weight bridge between the JAX reference and the port.

``torch`` cannot reproduce ``jax.random`` draws, so the parity tests start
both implementations from the same ``model.init`` / ``init_lora`` draws by
carrying the reference's trees across as numpy arrays. Trees are nested dicts
keyed by the same paths on both sides (``layers/attn/q_proj/kernel``,
``…/a``, ``…/b``). No JAX import: any array-like leaf (numpy, or a JAX array
via ``np.asarray``) is accepted.

bf16 leaves cross bit for bit. numpy has no bf16 of its own: JAX hands
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses, so such a
leaf (recognised by its dtype's name and itemsize, without importing
``ml_dtypes``) goes across as its 16-bit pattern and is viewed as
``torch.bfloat16`` on the torch side. Back, :func:`to_numpy` returns a bf16
tensor as float32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.util.device import resolve_device


def is_bf16(dtype: np.dtype) -> bool:
    """``dtype`` is a numpy-side bfloat16 (``ml_dtypes``' or any other of
    that name and width)."""
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def tensor_from_numpy(node: Any) -> torch.Tensor:
    """One array-like → a CPU tensor that owns a copy of it (bf16 kept bit
    for bit)."""
    arr = np.array(node, copy=True)
    if is_bf16(arr.dtype):
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Any, device="cuda") -> Dict[str, Any]:
    """Nested dict of array-likes → nested dict of tensors on ``device``
    (copied: the result never aliases the source arrays)."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node).to(dev)

    return walk(tree)


def to_numpy(tree: Any) -> Dict[str, Any]:
    """Nested dict of tensors → nested dict of numpy arrays (host copies; a
    bf16 tensor as float32, exactly)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
