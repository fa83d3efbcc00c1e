"""FedEx-LoRA core of the port: LoRA, aggregation, the round-close engine and
the federated trainer."""

from repro_torch.core.aggregation import (apply_residual, fedex_aggregate,
                                          fedex_residual, fedit_aggregate,
                                          map_factors, normalize_weights,
                                          product_mean, tree_mean)
from repro_torch.core.engine import (DeferredDivergence, RoundBuffers,
                                     RoundCloseEngine, make_close_fn)
from repro_torch.core.federated import (FederatedTrainer, make_eval_fn,
                                        make_local_step)
from repro_torch.core.lora import init_lora, merge_lora, resolve_targets

__all__ = ["DeferredDivergence", "FederatedTrainer", "RoundBuffers",
           "RoundCloseEngine", "apply_residual", "fedex_aggregate",
           "fedex_residual", "fedit_aggregate", "init_lora", "make_close_fn",
           "make_eval_fn", "make_local_step", "map_factors", "merge_lora",
           "normalize_weights", "product_mean", "resolve_targets",
           "tree_mean"]
