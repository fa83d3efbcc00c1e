"""Client data partitioning: IID and Dirichlet non-IID task mixtures.

The port's verbatim copy of ``repro/data/partition.py`` (numpy only).

The paper samples client data "at random" (§5 implementation details) in the
3-client cross-silo setting; we additionally support Dirichlet-α non-IID task
mixtures (the standard federated benchmark protocol, [62] in the paper) since
aggregation error is most visible under heterogeneity.
"""

from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(num_items: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_items)
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def dirichlet_partition(task_labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0) -> List[np.ndarray]:
    """Split item indices so each client's task mixture ~ Dirichlet(alpha).

    task_labels: (N,) int task id per item. Smaller alpha → more skew.
    """
    rng = np.random.default_rng(seed)
    num_tasks = int(task_labels.max()) + 1
    client_bins: List[List[int]] = [[] for _ in range(num_clients)]
    for t in range(num_tasks):
        items = np.where(task_labels == t)[0]
        rng.shuffle(items)
        props = rng.dirichlet(np.full(num_clients, alpha))
        # avoid empty clients: floor of one item per client when possible
        splits = (np.cumsum(props) * len(items)).astype(int)[:-1]
        for c, part in enumerate(np.split(items, splits)):
            client_bins[c].extend(part.tolist())
    out = []
    for c in range(num_clients):
        if not client_bins[c]:  # guarantee non-empty
            donor = int(np.argmax([len(b) for b in client_bins]))
            client_bins[c].append(client_bins[donor].pop())
        out.append(np.sort(np.array(client_bins[c], dtype=np.int64)))
    return out
