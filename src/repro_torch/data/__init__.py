from repro_torch.data.loader import ClientLoader
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import SyntheticLM, make_batch_for, to_batch

__all__ = ["ClientLoader", "SyntheticLM", "dirichlet_partition",
           "iid_partition", "make_batch_for", "to_batch"]
