"""Weight bridge between the JAX reference and the port.

``torch`` cannot reproduce ``jax.random`` draws, so the parity tests start
both implementations from the same ``model.init`` / ``init_lora`` draws by
carrying the reference's trees across as numpy arrays. Trees are nested dicts
keyed by the same paths on both sides (``layers/attn/q_proj/kernel``,
``…/a``, ``…/b``). No JAX import: any array-like leaf (numpy, or a JAX array
via ``np.asarray``) is accepted.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.util.device import resolve_device


def params_from_numpy(tree: Any, device="cuda") -> Dict[str, Any]:
    """Nested dict of array-likes → nested dict of tensors on ``device``
    (copied: the result never aliases the source arrays)."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.array(node, copy=True)
        return torch.from_numpy(arr).to(dev)

    return walk(tree)


def to_numpy(tree: Any) -> Dict[str, Any]:
    """Nested dict of tensors → nested dict of numpy arrays (host copies)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
