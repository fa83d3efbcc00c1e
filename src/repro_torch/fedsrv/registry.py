"""Client registry, participation sampler, and straggler/dropout models.

The port's copy of ``repro/fedsrv/registry.py`` (numpy only): the same
seeded draws, so sampling, example-count weights, arrival order and dropout
are the reference's bit for bit.

Everything here is *deterministic given (seed, round, client)*: random draws
use ``np.random.default_rng([seed, round, client])`` (SeedSequence spawning),
which is stable across processes and independent of PYTHONHASHSEED. The
simulated clock is a plain float accumulator — no wall time anywhere, so a
scenario replays bit-for-bit.

Per-purpose rng streams: latency/straggler draws use the bare
``[seed, round, client]`` stream, dropout the :data:`DROPOUT_STREAM` suffix
and fault injection the :data:`FAULT_STREAM` suffix, so consuming (or not
consuming) one family's draw never shifts another's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

# SeedSequence key suffixes, one per decision family (the reference's)
DROPOUT_STREAM = 1
FAULT_STREAM = 2


def purpose_rng(seed: int, round_id: int, client_id: int,
                *purpose: int) -> np.random.Generator:
    """The rng stream for one (seed, round, client, purpose…) decision.

    ``purpose`` suffixes isolate decision families from each other: two
    streams with different suffixes never alias, so draws in one family
    cannot bleed into another. The latency/straggler stream is the
    unsuffixed key (the reference's historical layout)."""
    return np.random.default_rng([seed, round_id, client_id, *purpose])


@dataclass(frozen=True)
class ClientInfo:
    """One registered client.

    num_examples drives the aggregation weight wᵢ = nᵢ/Σnⱼ over the round's
    delivered subset; compute_speed scales the straggler model's latency
    (2.0 → twice as fast as the fleet baseline).
    """

    client_id: int
    num_examples: int
    compute_speed: float = 1.0


class SimClock:
    """Deterministic simulated clock (seconds). Monotone, replayable.

    ``now_fn`` (e.g. ``time.monotonic``) pins the clock to wall time:
    :meth:`now` returns the real seconds elapsed since construction, so the
    HTTP service's round deadlines (``deadline = now() + round_deadline``)
    run on the coordinator's arithmetic in real seconds. ``advance`` /
    ``advance_to`` raise the monotone floor in both modes."""

    def __init__(self, start: float = 0.0, now_fn=None):
        self._t = float(start)
        self._now_fn = now_fn
        # maps now_fn()'s epoch onto the clock's axis (the floor _t stays)
        self._wall0 = None if now_fn is None else float(now_fn()) - self._t

    def now(self) -> float:
        if self._now_fn is not None:
            self._t = max(self._t, float(self._now_fn()) - self._wall0)
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t = self.now() + float(dt)
        return self._t

    def state_dict(self) -> dict:
        return {"t": self.now()}

    def load_state(self, state: dict) -> None:
        """Restore the exact float; in wall mode it becomes the new origin
        (elapsed time accrues on top)."""
        self._t = float(state["t"])
        if self._now_fn is not None:
            self._wall0 = float(self._now_fn()) - self._t


@dataclass(frozen=True)
class StragglerModel:
    """Seeded per-(round, client) latency and dropout draws.

    latency = mean_latency / compute_speed · lognormal(σ=jitter), optionally
    inflated by straggler_factor with prob straggler_prob. dropout_prob models
    a client that accepts the round but never reports back.
    """

    mean_latency: float = 1.0
    jitter: float = 0.25
    dropout_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 5.0
    seed: int = 0

    def _rng(self, round_id: int, client_id: int) -> np.random.Generator:
        return purpose_rng(self.seed, round_id, client_id)

    def draw(self, round_id: int, client: ClientInfo) -> "tuple[float, bool]":
        """(latency, is_straggler) for one (round, client)."""
        rng = self._rng(round_id, client.client_id)
        base = self.mean_latency / max(client.compute_speed, 1e-6)
        lat = base * float(np.exp(rng.normal(0.0, self.jitter)))
        straggled = (self.straggler_prob > 0
                     and rng.random() < self.straggler_prob)
        if straggled:
            lat *= self.straggler_factor
        return lat, straggled

    def latency(self, round_id: int, client: ClientInfo) -> float:
        return self.draw(round_id, client)[0]

    def dropped(self, round_id: int, client: ClientInfo) -> bool:
        """Whether the client never reports back this round (its own
        stream, so dropout and latency never alias)."""
        if self.dropout_prob <= 0:
            return False
        rng = purpose_rng(self.seed, round_id, client.client_id,
                          DROPOUT_STREAM)
        return bool(rng.random() < self.dropout_prob)


class ClientRegistry:
    """Registered clients + seeded per-round participation sampling."""

    def __init__(self, clients: Optional[Sequence[ClientInfo]] = None,
                 seed: int = 0):
        self.seed = seed
        self._clients: List[ClientInfo] = list(clients or [])
        ids = [c.client_id for c in self._clients]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate client ids in {ids}")


    # -- views -------------------------------------------------------------
    @property
    def clients(self) -> List[ClientInfo]:
        return sorted(self._clients, key=lambda c: c.client_id)

    def get(self, client_id: int) -> ClientInfo:
        for c in self._clients:
            if c.client_id == client_id:
                return c
        raise KeyError(client_id)

    # -- sampling ----------------------------------------------------------
    def sample_round(self, round_id: int, fraction: float = 1.0,
                     min_clients: int = 1) -> List[ClientInfo]:
        """Sample ⌈fraction·k⌉ participants for a round, without replacement.

        Deterministic in (registry seed, round_id). fraction=1.0 returns every
        client, in client_id order — the trivial synchronous policy.
        """
        if not self._clients:
            raise ValueError("empty registry")
        if fraction <= 0:
            raise ValueError(f"participation fraction must be > 0, got {fraction}")
        k = len(self._clients)
        if fraction >= 1.0:
            return self.clients
        m = min(k, max(min_clients, math.ceil(fraction * k)))
        rng = np.random.default_rng([self.seed, round_id])
        idx = sorted(rng.choice(k, size=m, replace=False).tolist())
        ordered = self.clients
        return [ordered[i] for i in idx]

    def weights_for(self, client_ids: Sequence[int]) -> List[float]:
        """Example-count weights wᵢ = nᵢ/Σnⱼ over a participating subset."""
        ns = [self.get(cid).num_examples for cid in client_ids]
        total = sum(ns)
        if total <= 0:
            raise ValueError(f"participating subset {client_ids} has no examples")
        return [n / total for n in ns]
