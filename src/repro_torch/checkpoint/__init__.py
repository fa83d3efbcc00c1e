"""Flat-path ``.npz`` checkpoints of tensor trees and the federated round
state (counterpart of ``repro/checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (ROUND_STATE_FILE,
                                               load_checkpoint,
                                               round_state_path,
                                               save_checkpoint)

__all__ = ["ROUND_STATE_FILE", "load_checkpoint", "round_state_path",
           "save_checkpoint"]
