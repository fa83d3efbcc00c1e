"""Synthetic LM corpora for federated experiments (offline stand-in for GLUE etc.)

The port's copy of ``repro/data/synthetic.py``: the numpy generators are
verbatim, so a seed gives the same tokens bit for bit; only the emission
changes — batches are torch int64 / float32 tensors on the requested device.

Each *task* is a random first-order Markov chain over the vocabulary. A corpus
is a mixture of tasks; non-IID client splits (see partition.py) give each
client a different task mixture. The transition tensor is dense
(tasks, vocab, vocab) float64, so the DATA vocabulary must stay small (at a
128,256-token vocabulary it would take ~526 GB); a full-vocabulary model
trains on a small data vocabulary instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.util.device import resolve_device


def to_batch(seqs: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """(N, seq_len + 1) token ids → tokens / targets / loss_mask tensors."""
    return {
        "tokens": torch.as_tensor(seqs[:, :-1], dtype=torch.int64,
                                  device=device),
        "targets": torch.as_tensor(seqs[:, 1:], dtype=torch.int64,
                                   device=device),
        "loss_mask": torch.ones(seqs[:, 1:].shape, dtype=torch.float32,
                                device=device),
    }


class SyntheticLM:
    """Markov-mixture corpus generator.

    >>> ds = SyntheticLM(vocab=64, num_tasks=4, seed=0)
    >>> seqs = ds.sample(task=1, num_sequences=8, seq_len=32)
    >>> seqs.shape
    (8, 33)
    """

    def __init__(self, vocab: int, num_tasks: int = 4, seed: int = 0,
                 concentration: float = 0.3):
        self.vocab = vocab
        self.num_tasks = num_tasks
        rng = np.random.default_rng(seed)
        # per-task transition matrices, rows ~ Dirichlet(concentration)
        self.transitions = np.stack([
            rng.dirichlet(np.full(vocab, concentration), size=vocab)
            for _ in range(num_tasks)
        ])  # (T, V, V)

    def sample(self, task: int, num_sequences: int, seq_len: int,
               seed: Optional[int] = None) -> np.ndarray:
        """Returns token ids (num_sequences, seq_len + 1) — inputs ‖ final target."""
        rng = np.random.default_rng(seed)
        p = self.transitions[task % self.num_tasks]
        out = np.empty((num_sequences, seq_len + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=num_sequences)
        # vectorised chain sampling via inverse-CDF
        cdf = np.cumsum(p, axis=-1)
        for t in range(seq_len):
            u = rng.random(num_sequences)[:, None]
            out[:, t + 1] = (u > cdf[out[:, t]]).sum(axis=-1)
        return np.clip(out, 0, self.vocab - 1)

    def to_batch(self, seqs: np.ndarray,
                 device: torch.device) -> Dict[str, torch.Tensor]:
        return to_batch(seqs, device)


def make_batch_for(cfg, batch_size: int, seq_len: int, seed: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Random batch of any family (smoke tests, serving prompts), the
    reference's ``make_batch_for`` draws from one generator: a vlm config's
    ``vision_embeds`` first, ``normal × 0.02`` over (batch, vision_tokens,
    d_model) as float32, with ``max(1, seq_len − vision_tokens)`` text
    tokens after them; an encdec config's ``frames`` likewise over (batch,
    enc_seq_len, d_model); then the tokens, ``integers(0, vocab)`` over
    (batch, text + 1) — so the extras and the token values are the
    reference's bit for bit — as tensors on ``device``. ``loss_mask`` is
    (batch, text)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    text_len, extras = seq_len, {}
    if cfg.family == "vlm":
        text_len = max(1, seq_len - cfg.vision_tokens)
        extras["vision_embeds"] = rng.normal(
            size=(batch_size, cfg.vision_tokens, cfg.d_model)) * 0.02
    if cfg.family == "encdec":
        extras["frames"] = rng.normal(
            size=(batch_size, cfg.enc_seq_len, cfg.d_model)) * 0.02
    toks = rng.integers(0, cfg.vocab_size, size=(batch_size, text_len + 1))
    batch = to_batch(toks, dev)
    for k, v in extras.items():
        batch[k] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return batch
