"""PyTorch/CUDA port of the FedEx-LoRA system (the JAX package ``repro`` is
the reference).

The layout mirrors ``repro``: ``configs``, ``data``, ``models``, ``core``
(LoRA, aggregation operators, the round-close engine, the federated trainer),
``optim``, ``kernels`` (hand-written CUDA kernels for Hopper, each with a
plain PyTorch version beside it), ``fedsrv`` (registry and coordinator) and
``launch``. Nothing here imports JAX or the JAX package: what the port needs
from the reference's framework-neutral modules it keeps as its own copy.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
