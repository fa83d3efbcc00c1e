"""FedEx-LoRA core of the port: LoRA, aggregation, the round-close engine,
the federated trainer, and the §6 / Table 6 accounting and §7 DP uploads."""

from repro_torch.core.aggregation import (apply_residual,
                                          assign_after_aggregation,
                                          fedex_aggregate, fedex_residual,
                                          fedex_svd_aggregate,
                                          fedit_aggregate, ffa_aggregate,
                                          map_factors, normalize_weights,
                                          per_client_residuals, product_mean,
                                          tree_mean)
from repro_torch.core.decompose import (factored_residual_params,
                                        reconstruct, residual_factors,
                                        truncated_residual_params,
                                        truncated_svd_product)
from repro_torch.core.divergence import (deviation_tree, flatten_deviations,
                                         mean_deviation)
from repro_torch.core.engine import (DeferredDivergence, RoundBuffers,
                                     RoundCloseEngine, make_close_fn)
from repro_torch.core.federated import (FederatedTrainer, make_eval_fn,
                                        make_local_step)
from repro_torch.core.lora import (init_global_state, init_lora, merge_lora,
                                   resolve_targets)

__all__ = ["DeferredDivergence", "FederatedTrainer", "RoundBuffers",
           "RoundCloseEngine", "apply_residual", "assign_after_aggregation",
           "deviation_tree", "factored_residual_params", "fedex_aggregate",
           "fedex_residual", "fedex_svd_aggregate", "fedit_aggregate",
           "ffa_aggregate", "flatten_deviations", "init_global_state",
           "init_lora",
           "make_close_fn", "make_eval_fn", "make_local_step", "map_factors",
           "mean_deviation", "merge_lora", "normalize_weights",
           "per_client_residuals", "product_mean", "reconstruct",
           "residual_factors", "resolve_targets", "tree_mean",
           "truncated_residual_params", "truncated_svd_product"]
