from repro_torch.util.device import resolve_device
from repro_torch.util.tree import (count_params, flatten_with_paths,
                                   unflatten_from_paths)

__all__ = ["count_params", "flatten_with_paths", "resolve_device",
           "unflatten_from_paths"]
