"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

* :func:`fedex_fold` (``fedex_residual.py``, ``csrc/fedex_fold.cu``) — the
  exact residual fold W0 + scale·(Σ w_c a_c b_c − ā b̄); replaces the TPU
  kernel ``fedex_residual_apply``.
* :func:`factor_mean` (``factor_mean.py``, ``csrc/factor_mean.cu``) — the
  weighted client mean of stacked factors; replaces ``lora_factor_mean``.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
its ``launches`` attribute) and takes the plain version only for CPU
tensors. The kernels build with ``nvcc`` on first use (``build.py``).
"""

from repro_torch.kernels.factor_mean import factor_mean, factor_mean_plain
from repro_torch.kernels.fedex_residual import (fedex_fold, fedex_fold_plain,
                                                fold_error_bound)

__all__ = ["factor_mean", "factor_mean_plain", "fedex_fold",
           "fedex_fold_plain", "fold_error_bound"]
