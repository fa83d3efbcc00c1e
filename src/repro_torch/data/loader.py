"""Per-client batching over a materialised corpus (host-side, numpy).

The port's copy of ``repro/data/loader.py``: the same shuffling draws, so the
batch sequence is the reference's bit for bit; batches are emitted as torch
tensors on the loader's device.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import to_batch
from repro_torch.util.device import resolve_device


class ClientLoader:
    """Infinite shuffled batch iterator over one client's sequences.

    sequences: (N, seq_len + 1) int32 — inputs are [:, :-1], targets [:, 1:].
    Batches land on ``device`` (default CUDA; the CPU must be asked for).
    """

    def __init__(self, sequences: np.ndarray, batch_size: int, seed: int = 0,
                 device="cuda"):
        if len(sequences) == 0:
            raise ValueError("empty client shard")
        self.sequences = sequences
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(sequences))
        self._cursor = 0

    def next_batch(self) -> Dict[str, torch.Tensor]:
        n = len(self.sequences)
        idx = []
        while len(idx) < self.batch_size:
            if self._cursor >= n:
                self._order = self.rng.permutation(n)
                self._cursor = 0
            take = min(self.batch_size - len(idx), n - self._cursor)
            idx.extend(self._order[self._cursor : self._cursor + take].tolist())
            self._cursor += take
        return to_batch(self.sequences[np.asarray(idx)], self.device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()

    def state_dict(self) -> Dict:
        """JSON-able iterator state: a resumed loader draws the same batch
        sequence as an uninterrupted one."""
        return {"rng": self.rng.bit_generator.state,
                "order": self._order.tolist(), "cursor": self._cursor}

    def load_state(self, state: Dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._order = np.asarray(state["order"], dtype=np.int64)
        self._cursor = int(state["cursor"])
