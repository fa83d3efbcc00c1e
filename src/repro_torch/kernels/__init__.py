"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

* :func:`fedex_fold` (``fedex_residual.py``, ``csrc/fedex_fold.cu``) — the
  exact residual fold W0 + scale·(Σ w_c a_c b_c − ā b̄); replaces the TPU
  kernel ``fedex_residual_apply``.
* :func:`factor_mean_group` (``factor_mean.py``, ``csrc/factor_mean.cu``) —
  the weighted client mean of a group of stacked factors in one launch
  (:func:`factor_mean` is its one-tensor case); replaces
  ``lora_factor_mean``.
* :func:`product_fold` (``csrc/product_fold.cu``) — W0 + scale·Σ s_c a_c b_c
  with signed s (reinit, fedex_svd); replaces ``product_fold_apply``.
* :func:`product_accum` (``csrc/product_accum.cu``) — acc ← acc +
  scale·Σ_c s_c a_c b_c in place, the chunked closes' partial fold;
  replaces ``product_accum_apply``.
* :func:`perclient_fold` (``csrc/perclient_fold.cu``) — every delivered
  lane's own W0_c + scale·(Σ w_j a_j b_j − a_c b_c) (keep_local); replaces
  ``perclient_fold_apply``.
* :func:`hetero_fold` (``csrc/hetero_fold.cu``) — the rank-masked per-lane
  fold of the hetero close; replaces ``hetero_fold_apply``.
* :func:`lora_matmul` (``lora_matmul.py``, ``csrc/lora_matmul.cu``) — the
  fused LoRA projection x@W + scale·(x@a)@b of serving (via
  :func:`lora_dense`; bf16 on the tensor cores, prefill counted in
  ``lora_matmul.bf16_tc_launches``, decode in
  ``lora_matmul.bf16_tc_decode_launches``); replaces ``lora_matmul``.
* :func:`flash_swa` (``flash_swa.py``, ``csrc/flash_swa.cu``) — causal /
  sliding-window flash attention forward, the prefill attention of serving
  (via :func:`swa_attention`, GQA in place; bf16 on the tensor cores,
  counted in ``flash_swa.bf16_tc_launches``); replaces ``flash_swa``.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
its ``launches`` attribute) and takes the plain version only for CPU
tensors. The serving kernels (``lora_matmul``, ``flash_swa``) take float32
or bfloat16 operands (never a mix); the folds float32. The kernels build with ``nvcc`` on first use (``build.py``).
"""

from repro_torch.kernels.factor_mean import (factor_mean, factor_mean_group,
                                             factor_mean_plain)
from repro_torch.kernels.fedex_residual import (fedex_fold, fedex_fold_plain,
                                                fold_error_bound, hetero_error_bound,
                                                hetero_fold, hetero_fold_plain,
                                                perclient_error_bound,
                                                perclient_fold,
                                                perclient_fold_plain,
                                                product_accum,
                                                product_accum_error_bound,
                                                product_accum_plain,
                                                product_error_bound,
                                                product_fold, product_fold_plain)
from repro_torch.kernels.flash_swa import (flash_swa, flash_swa_plain,
                                           swa_attention, swa_attention_plain,
                                           swa_error_bound)
from repro_torch.kernels.lora_matmul import (lora_dense, lora_dense_plain,
                                             lora_matmul,
                                             lora_matmul_error_bound,
                                             lora_matmul_plain)

KERNELS = (fedex_fold, factor_mean, product_fold, product_accum,
           perclient_fold, hetero_fold, lora_matmul, flash_swa)


BF16_KERNELS = (lora_matmul, flash_swa)  # those that take bf16 operands


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counters to 0."""
    for fn in KERNELS:
        fn.launches = 0
    for fn in BF16_KERNELS:
        fn.bf16_launches = 0
    lora_matmul.bf16_tc_launches = 0
    lora_matmul.bf16_tc_decode_launches = 0
    flash_swa.bf16_tc_launches = 0


def launch_counts() -> dict:
    """Kernel name → launches since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def bf16_launch_counts() -> dict:
    """Kernel name → its bf16 launches since the last reset (a share of
    :func:`launch_counts`)."""
    return {fn.__name__: fn.bf16_launches for fn in BF16_KERNELS}


__all__ = ["BF16_KERNELS", "KERNELS", "bf16_launch_counts", "factor_mean", "factor_mean_group", "factor_mean_plain",
           "fedex_fold", "fedex_fold_plain", "flash_swa", "flash_swa_plain",
           "fold_error_bound", "hetero_error_bound", "hetero_fold",
           "hetero_fold_plain", "launch_counts", "lora_dense",
           "lora_dense_plain", "lora_matmul", "lora_matmul_error_bound",
           "lora_matmul_plain", "perclient_error_bound", "perclient_fold", "perclient_fold_plain",
           "product_accum", "product_accum_error_bound", "product_accum_plain",
           "product_error_bound", "product_fold", "product_fold_plain",
           "reset_launch_counts", "swa_attention", "swa_attention_plain",
           "swa_error_bound"]
