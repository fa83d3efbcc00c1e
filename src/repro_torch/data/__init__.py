from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import SyntheticLM, to_batch

__all__ = ["ClientLoader", "SyntheticLM", "dirichlet_partition",
           "iid_partition", "to_batch"]
