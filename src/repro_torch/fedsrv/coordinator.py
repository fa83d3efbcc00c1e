"""Synchronous round coordinator: open → collect → close (weighted, exact).

Counterpart of ``repro/fedsrv/coordinator.py``'s ``RoundCoordinator``,
restricted to participation sampling, ``min_quorum`` and the weighting
policy. A round samples its participants, orders their arrivals by the
seeded straggler latencies, assigns lanes in client-id order (the
reference's ``_open_sink``), runs ``train_fn`` for each arrival and writes
the uplink straight into the :class:`~repro_torch.core.engine.RoundBuffers`
sink (codec ``none``: the device tensors themselves, no encode/decode).

Uplink validation keeps the reference's finite check: an uplink with a
non-finite value is quarantined — its lane stays zero and it is not
delivered — and a round left below quorum is degraded (its buffer set is
evicted). Deadlines, dropout, quantized codecs, fault injection, async
buffering and the bytes ledger are not ported; the trainer refuses configs
that ask for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.fedsrv.registry import (ClientInfo, ClientRegistry, SimClock,
                                         StragglerModel)
from repro_torch.util.tree import flatten_with_paths

TrainFn = Callable[[ClientInfo, Any, int], Any]


@dataclass(frozen=True)
class RoundPolicy:
    """participation — fraction of registered clients sampled per round;
    min_quorum — deliveries a round needs (0 → one); weighting — "uniform"
    or "examples" (wᵢ = nᵢ/Σnⱼ)."""

    participation: float = 1.0
    min_quorum: int = 0
    weighting: str = "uniform"  # uniform | examples


@dataclass
class Delivery:
    client: ClientInfo
    lora: Any
    launched_at: float
    arrived_at: float


@dataclass
class RoundOutcome:
    round_id: int
    sampled: List[int]
    delivered: List[Delivery]
    weights: Optional[List[float]]  # None → uniform
    opened_at: float
    closed_at: float
    # (client_id, reason) pairs whose uplink was quarantined
    quarantined: List[Tuple[int, str]] = field(default_factory=list)
    # quorum failed after quarantine: the trainer carries the global forward
    degraded: bool = False

    @property
    def client_ids(self) -> List[int]:
        return [d.client.client_id for d in self.delivered]


def _finite(tree: Any) -> bool:
    """One host sync per uplink: any NaN/±Inf propagates into the f64 sum."""
    leaves = flatten_with_paths(tree).values()
    total = torch.stack([x.sum(dtype=torch.float64) for x in leaves]).sum()
    return bool(torch.isfinite(total))


class RoundCoordinator:
    """Synchronous coordinator with participation sampling and quorum. With
    the default policy it runs every client, in client-id order, uniform."""

    def __init__(self, registry: ClientRegistry,
                 policy: Optional[RoundPolicy] = None,
                 stragglers: Optional[StragglerModel] = None,
                 clock: Optional[SimClock] = None,
                 sink: Optional[Any] = None, validate: bool = True):
        self.registry = registry
        self.policy = policy or RoundPolicy()
        if self.policy.weighting not in ("uniform", "examples"):
            raise ValueError(f"unknown weighting {self.policy.weighting!r}")
        self.stragglers = stragglers or StragglerModel()
        self.clock = clock or SimClock()
        self.sink = sink
        self.validate = validate

    def _open_sink(self, candidates: List[int], round_id: int) -> None:
        """Lanes in client-id order over the round's candidates."""
        if self.sink is not None and candidates:
            self.sink.begin_round(
                {cid: i for i, cid in enumerate(sorted(candidates))},
                round_id=round_id)

    def _uplink(self, lora: Any, round_id: int, client_id: int, *,
                weight: float = 1.0) -> bool:
        """Validate one uplink and write it into the sink with its raw
        weight (a chunked ring folds it in at ingest)."""
        if self.validate and not _finite(lora):
            return False
        if self.sink is not None:
            self.sink.write(client_id, lora, round_id=round_id, weight=weight)
        return True

    def run_round(self, round_id: int, train_fn: TrainFn, global_lora: Any
                  ) -> RoundOutcome:
        pol = self.policy
        participants = self.registry.sample_round(round_id, pol.participation,
                                                  max(1, pol.min_quorum))
        opened = self.clock.now()
        arrivals: List[Tuple[float, ClientInfo]] = []
        for c in participants:
            lat, _ = self.stragglers.draw(round_id, c)
            arrivals.append((opened + lat, c))
        arrivals.sort(key=lambda tc: (tc[0], tc[1].client_id))
        quorum = max(1, pol.min_quorum)
        quorum = min(quorum, len(arrivals)) if arrivals else 0
        self._open_sink([c.client_id for _, c in arrivals], round_id)

        delivered: List[Delivery] = []
        quarantined: List[Tuple[int, str]] = []
        for t, c in arrivals:
            lora_c = train_fn(c, global_lora, round_id)
            ok = self._uplink(lora_c, round_id, c.client_id,
                              weight=(float(c.num_examples)
                                      if pol.weighting == "examples"
                                      else 1.0))
            self.clock.advance_to(t)
            if ok:
                delivered.append(Delivery(client=c, lora=lora_c,
                                          launched_at=opened, arrived_at=t))
            else:
                quarantined.append((c.client_id, "nonfinite"))
        closed = self.clock.now()
        delivered.sort(key=lambda d: d.client.client_id)

        degraded = bool(arrivals) and len(delivered) < quorum
        if degraded and self.sink is not None \
                and round_id in self.sink.open_rounds:
            self.sink.evict(round_id)

        weights = None
        if pol.weighting == "examples" and delivered:
            weights = self.registry.weights_for(
                [d.client.client_id for d in delivered])
        return RoundOutcome(
            round_id=round_id, sampled=[c.client_id for c in participants],
            delivered=delivered, weights=weights, opened_at=opened,
            closed_at=closed, quarantined=quarantined, degraded=degraded)
