"""Round coordinators: open → collect → close (weighted, exact).

Counterpart of ``repro/fedsrv/coordinator.py``.

Synchronous mode (:class:`RoundCoordinator`): a round samples its
participants, draws each one's dropout and arrival time from the seeded
straggler model, and collects deliveries in arrival order until the
deadline passes with the quorum met (``deadline=0`` waits for every client
that did not drop out). Every non-dropout candidate gets a lane in
client-id order up front; a lane the deadline cut is never written and
carries weight 0 at the close.

Asynchronous mode (:class:`AsyncBufferCoordinator`, FedBuff): clients
launch against the current global version and arrive after their latency;
each call commits the ``buffer_size`` earliest arrivals, each trained from
its launch-version snapshot and weighted n·(1 + staleness)^(−α),
renormalised at the commit.

Training is injected as ``train_fn(client, start_lora, round_id) → lora``.
Every uplink crosses the :class:`~repro_torch.fedsrv.transport.
AdapterCodec` (so quantization is part of what is aggregated), is decoded
straight into the sink's lane (:class:`~repro_torch.core.engine.
RoundBuffers`) when there is one, and lands in the
:class:`~repro_torch.fedsrv.transport.BytesLedger`: a payload that fails
validation is quarantined (its lane stays unread), one the ring refuses is
dropped. A :class:`~repro_torch.fedsrv.faults.FaultInjector` (``faults``)
corrupts each encoded uplink before delivery: a crash, and a replay with no
ring to refuse it, drop the uplink; a duplicate is delivered twice and the
ring drops the copy; a transient decode error is retried with backoff on
the clock. Every federation decision comes from the numpy ``purpose_rng``
streams, so outcomes replay the reference's exactly.

With a live ``recorder`` (:mod:`repro_torch.obs`, handed down to the codec)
a round records nested spans (``round.collect`` or ``commit.collect`` →
``client.train`` → ``client.uplink`` → codec and ring), its open, dropout,
deadline-drop, retry, quarantine and degraded events and counters, and its
client counts on its round record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.fedsrv.registry import (ClientInfo, ClientRegistry, SimClock,
                                         StragglerModel)
from repro_torch.fedsrv.transport import (AdapterCodec, BytesLedger,
                                          StaleUplinkError,
                                          TransientTransportError,
                                          TransportError)
from repro_torch.obs import NULL
from repro_torch.util.tree import count_params

TrainFn = Callable[[ClientInfo, Any, int], Any]


@dataclass(frozen=True)
class RoundPolicy:
    """participation — fraction of registered clients sampled per round;
    min_quorum — deliveries required before the deadline may cut late
    arrivals (0 → one); deadline — sim-seconds after the round opens at
    which late arrivals are dropped once the quorum is met (0 → none);
    weighting — "uniform" or "examples" (wᵢ = nᵢ/Σnⱼ)."""

    participation: float = 1.0
    min_quorum: int = 0
    deadline: float = 0.0
    weighting: str = "uniform"  # uniform | examples


@dataclass
class Delivery:
    client: ClientInfo
    lora: Any
    launched_at: float
    arrived_at: float
    staleness: int = 0  # async: commits since the launch version


@dataclass
class RoundOutcome:
    round_id: int
    sampled: List[int]
    delivered: List[Delivery]
    dropped_out: List[int]          # never reported back
    dropped_deadline: List[int]     # arrived after the deadline, quorum met
    weights: Optional[List[float]]  # None → uniform
    opened_at: float
    closed_at: float
    comm: Dict[str, int] = field(default_factory=dict)
    # (client_id, reason) pairs whose uplink was quarantined or dropped
    quarantined: List[Tuple[int, str]] = field(default_factory=list)
    # quorum failed after quarantine: the trainer carries the global forward
    degraded: bool = False
    retries: int = 0  # transient decode retries spent this round

    @property
    def client_ids(self) -> List[int]:
        return [d.client.client_id for d in self.delivered]


@dataclass
class UplinkResult:
    """What became of one client's uplink (:meth:`RoundCoordinator.
    _uplink`)."""

    ok: bool
    tree: Any = None     # the decoded tree when ok
    reason: str = ""     # quarantine/drop reason when not ok
    status: str = "delivered"  # delivered | quarantined | dropped
    retries: int = 0


class RoundCoordinator:
    """Synchronous coordinator with sampling, dropout, deadline and quorum.
    With the default policy it runs every client, in client-id order,
    uniform, through the ``none`` codec."""

    def __init__(self, registry: ClientRegistry,
                 policy: Optional[RoundPolicy] = None,
                 stragglers: Optional[StragglerModel] = None,
                 codec: Optional[AdapterCodec] = None,
                 ledger: Optional[BytesLedger] = None,
                 clock: Optional[SimClock] = None,
                 sink: Optional[Any] = None,
                 faults: Optional[Any] = None,
                 uplink_retries: int = 2,
                 retry_backoff: float = 0.05,
                 recorder: Optional[Any] = None):
        self.registry = registry
        self.policy = policy or RoundPolicy()
        if self.policy.weighting not in ("uniform", "examples"):
            raise ValueError(f"unknown weighting {self.policy.weighting!r}")
        self.stragglers = stragglers or StragglerModel()
        self.codec = codec or AdapterCodec("none")
        self.ledger = ledger or BytesLedger()
        self.clock = clock or SimClock()
        self.faults = faults  # a FaultInjector, or None
        # transient decode failures: bounded retries, backing off
        # retry_backoff · 2^attempt sim-seconds
        if uplink_retries < 0:
            raise ValueError(f"uplink_retries must be ≥ 0, got "
                             f"{uplink_retries}")
        self.uplink_retries = uplink_retries
        self.retry_backoff = retry_backoff
        self.rec = recorder if recorder is not None else NULL
        if self.rec.enabled and not self.codec.rec.enabled:
            self.codec.rec = self.rec
        self.sink = sink
        self._downlink_params: Optional[int] = None  # adapter tree is static

    # ------------------------------------------------------------------
    def _open_sink(self, candidates: List[int], round_id: int, *,
                   deadline: Optional[float] = None,
                   now: Optional[float] = None) -> None:
        """Lanes in client-id order over the round's candidates; the
        deadline makes the round evictable from a full ring (sim-seconds
        here, commit versions under FedBuff)."""
        if self.sink is not None and candidates:
            self.sink.begin_round(
                {cid: i for i, cid in enumerate(sorted(candidates))},
                round_id=round_id, deadline=deadline, now=now)

    def _deliver(self, payload: Any, weight: float = 1.0) -> Tuple[Any, int]:
        """Decode one payload (into the sink when there is one), retrying a
        transient failure with backoff. Returns (decoded tree, retries);
        raises TransportError / StaleUplinkError to quarantine / drop."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    # a transient failure belongs to this delivery attempt,
                    # not to the (frozen) payload
                    self.faults.check_transient(payload.round_id,
                                                payload.client_id)
                if self.sink is not None:
                    return self.codec.decode_into(payload, self.sink,
                                                  weight=weight), attempt
                return self.codec.decode(payload), attempt
            except TransientTransportError as e:
                if attempt >= self.uplink_retries:
                    raise TransportError(
                        f"retries exhausted after {attempt} backoffs: {e}",
                        round_id=payload.round_id,
                        client_id=payload.client_id,
                        reason="retries_exhausted") from e
                self.clock.advance(self.retry_backoff * (2 ** attempt))
                attempt += 1
                if self.rec.enabled:
                    self.rec.counter("uplink.retries").inc()
                    self.rec.event("uplink.retry", cat="fedsrv",
                                   round=payload.round_id,
                                   client=payload.client_id, attempt=attempt)

    def _uplink(self, lora: Any, round_id: int, client_id: int, *,
                weight: float = 1.0,
                rank: Optional[int] = None) -> UplinkResult:
        """Client → server through the codec; the server aggregates what
        was transmitted. ``weight`` is the client's raw aggregation weight
        at delivery (a chunked sink folds it in at ingest, so it must
        normalise to the close's weighting). A validation failure
        quarantines the uplink (ledger direction ``quarantined``); a ring
        refusal, a crash, or a replay with no ring drops it (``dropped``).
        ``rank`` declares a ragged (hetero) uplink's true rank."""
        with self.rec.span("client.uplink", cat="fedsrv", round=round_id,
                           client=client_id):
            return self._uplink_body(lora, round_id, client_id, weight, rank)

    def _uplink_body(self, lora, round_id, client_id, weight, rank
                     ) -> UplinkResult:
        payload = self.codec.encode(lora, round_id=round_id,
                                    client_id=client_id, direction="uplink",
                                    rank=rank)
        kinds: List[str] = []
        if self.faults is not None:
            payload, applied = self.faults.corrupt(payload)
            kinds = [s.kind for s in applied]
        if "crash" in kinds:
            # the client died mid-uplink: nothing reaches the server
            self.ledger.record(payload, note="fault:crash",
                               direction="dropped")
            self._note_undelivered(round_id, client_id, "crash", "dropped")
            return UplinkResult(ok=False, reason="crash", status="dropped")
        if payload.round_id != round_id and self.sink is None:
            # a replayed address with no ring to refuse it
            self.ledger.record(payload, note="drop:replay",
                               direction="dropped")
            self._note_undelivered(round_id, client_id, "replay", "dropped")
            return UplinkResult(ok=False, reason="replay", status="dropped")
        try:
            tree, retries = self._deliver(payload, weight)
        except StaleUplinkError as e:
            self.ledger.record(payload, note=f"drop:{e.reason}",
                               direction="dropped")
            self._note_undelivered(round_id, client_id, e.reason, "dropped")
            return UplinkResult(ok=False, reason=e.reason, status="dropped")
        except TransportError as e:
            self.ledger.record(payload, note=f"quarantine:{e.reason}",
                               direction="quarantined")
            self._note_undelivered(round_id, client_id, e.reason,
                                   "quarantined")
            return UplinkResult(ok=False, reason=e.reason,
                                status="quarantined")
        self.ledger.record(payload)
        if "duplicate" in kinds:
            # the copy costs wire bytes, and the ring refuses its write
            try:
                self._deliver(payload)
            except StaleUplinkError:
                pass
            self.ledger.record(payload, note="fault:duplicate",
                               direction="dropped")
        return UplinkResult(ok=True, tree=tree, retries=retries)

    def _note_undelivered(self, round_id: int, client_id: int, reason: str,
                          status: str) -> None:
        """The downlink that fed an undelivered uplink never became
        aggregate input: re-bucket it as ``dropped``; count the uplink as
        ``uplink.{status}[{reason}]``."""
        self.ledger.reclassify(round_id, client_id, "downlink", "dropped",
                               note=f"fed a {status} uplink")
        if self.rec.enabled:
            self.rec.counter(f"uplink.{status}[{reason}]").inc()
            self.rec.event("uplink.quarantine" if status == "quarantined"
                           else "uplink.drop", cat="fedsrv", round=round_id,
                           client=client_id, reason=reason)

    def _note_degraded(self, round_id: int, delivered: int, quorum: int,
                       quarantined: int) -> None:
        if self.rec.enabled:
            self.rec.counter("round.degraded").inc()
        self.rec.event("round.degraded", cat="fedsrv", round=round_id,
                       delivered=delivered, quorum=quorum,
                       quarantined=quarantined)

    def _ensure_spec(self, global_lora: Any) -> None:
        """Register the global adapter's (path → shape) spec with the codec
        on first use: every honest uplink must match it."""
        v = self.codec.validation
        if v.enabled and v.check_spec and self.codec.spec is None:
            self.codec.register_spec(global_lora)

    def _record_downlink(self, lora: Any, round_id: int,
                         client_id: int) -> None:
        """The downlink is float32 and the client trains on the global tree
        itself, so it is recorded analytically."""
        if self._downlink_params is None:
            self._downlink_params = count_params(lora)
        self.ledger.record_analytic(round_id, "downlink",
                                    self._downlink_params,
                                    client_id=client_id,
                                    note="global adapters")

    def _evict_sink_round(self, round_id: int, reason: str) -> None:
        """Evict a degraded round's set so the ring never wedges on a round
        nobody will close."""
        if self.sink is not None and round_id in self.sink.open_rounds:
            self.sink.evict(round_id, reason=reason)

    # ------------------------------------------------------------------
    def run_round(self, round_id: int, train_fn: TrainFn, global_lora: Any
                  ) -> RoundOutcome:
        pol = self.policy
        self._ensure_spec(global_lora)
        participants = self.registry.sample_round(round_id, pol.participation,
                                                  max(1, pol.min_quorum))
        opened = self.clock.now()
        self.rec.event("round.open", cat="fedsrv", round=round_id,
                       sampled=len(participants))

        # the event queue: dropout draws, then arrival times
        dropped_out: List[int] = []
        stragglers = 0
        arrivals: List[Tuple[float, ClientInfo]] = []
        for c in participants:
            if self.stragglers.dropped(round_id, c):
                dropped_out.append(c.client_id)
                self.rec.event("client.dropout", cat="fedsrv", round=round_id,
                               client=c.client_id)
                continue
            lat, straggled = self.stragglers.draw(round_id, c)
            stragglers += int(straggled)
            arrivals.append((opened + lat, c))
        arrivals.sort(key=lambda tc: (tc[0], tc[1].client_id))

        # deliveries required before the deadline may cut late arrivals
        # (min_quorum 0 → one; without a deadline every non-dropout waits)
        quorum = max(1, pol.min_quorum)
        quorum = min(quorum, len(arrivals)) if arrivals else 0

        # every non-dropout candidate gets a lane up front; the policy
        # deadline doubles as the ring's eviction deadline
        self._open_sink([c.client_id for _, c in arrivals], round_id,
                        deadline=(opened + pol.deadline
                                  if pol.deadline > 0 else None),
                        now=opened)

        delivered: List[Delivery] = []
        dropped_deadline: List[int] = []
        quarantined: List[Tuple[int, str]] = []
        retries = 0
        with self.rec.span("round.collect", cat="fedsrv", round=round_id,
                           candidates=len(arrivals), quorum=quorum):
            for t, c in arrivals:
                late = pol.deadline > 0 and t > opened + pol.deadline
                if late and len(delivered) >= quorum:
                    dropped_deadline.append(c.client_id)
                    self.rec.event("client.deadline_drop", cat="fedsrv",
                                   round=round_id, client=c.client_id,
                                   arrived_at=t)
                    continue
                self._record_downlink(global_lora, round_id, c.client_id)
                with self.rec.span("client.train", cat="fedsrv",
                                   round=round_id, client=c.client_id):
                    lora_c = train_fn(c, global_lora, round_id)
                res = self._uplink(lora_c, round_id, c.client_id,
                                   weight=(float(c.num_examples)
                                           if pol.weighting == "examples"
                                           else 1.0))
                # the arrival consumed sim-time whether or not it delivered
                self.clock.advance_to(t)
                retries += res.retries
                if res.ok:
                    delivered.append(Delivery(client=c, lora=res.tree,
                                              launched_at=opened,
                                              arrived_at=t))
                else:
                    quarantined.append((c.client_id, res.reason))

        closed = self.clock.now()  # the last arrival this round
        delivered.sort(key=lambda d: d.client.client_id)

        # quarantine can starve a round below quorum: the round never
        # closes, its set is evicted and the trainer carries the global
        degraded = bool(arrivals) and len(delivered) < quorum
        if degraded:
            self._evict_sink_round(round_id, "degraded: quorum failed after "
                                   "quarantine")
            self._note_degraded(round_id, len(delivered), quorum,
                                len(quarantined))

        weights = None
        if pol.weighting == "examples" and delivered:
            weights = self.registry.weights_for(
                [d.client.client_id for d in delivered])
        if self.rec.enabled:
            self.rec.round_set(round_id, sampled=len(participants),
                               delivered=len(delivered),
                               stragglers=stragglers,
                               dropped_out=len(dropped_out),
                               deadline_drops=len(dropped_deadline),
                               quarantined=len(quarantined),
                               retries=retries, degraded=int(degraded),
                               opened_at=round(opened, 3),
                               closed_at=round(closed, 3))
        return RoundOutcome(
            round_id=round_id, sampled=[c.client_id for c in participants],
            delivered=delivered, dropped_out=dropped_out,
            dropped_deadline=dropped_deadline, weights=weights,
            opened_at=opened, closed_at=closed,
            comm=self.ledger.round_totals(round_id),
            quarantined=quarantined, degraded=degraded, retries=retries)


class AsyncBufferCoordinator(RoundCoordinator):
    """FedBuff-style buffered commits with staleness-discounted exact folds.

    Each :meth:`run_round` is one server commit: newly sampled clients that
    are not busy launch against the current global version, then the
    ``buffer_size`` earliest arrivals (possibly launched several versions
    ago) are trained from their launch-version snapshot and committed
    together. The commit's ring set expires ``max_version_lag`` versions
    after it opens.
    """

    def __init__(self, registry: ClientRegistry,
                 policy: Optional[RoundPolicy] = None,
                 stragglers: Optional[StragglerModel] = None,
                 codec: Optional[AdapterCodec] = None,
                 ledger: Optional[BytesLedger] = None,
                 clock: Optional[SimClock] = None,
                 buffer_size: int = 2,
                 staleness_alpha: float = 0.5,
                 max_version_lag: int = 1,
                 sink: Optional[Any] = None,
                 faults: Optional[Any] = None,
                 uplink_retries: int = 2,
                 retry_backoff: float = 0.05,
                 recorder: Optional[Any] = None):
        super().__init__(registry, policy, stragglers, codec, ledger, clock,
                         sink=sink, faults=faults,
                         uplink_retries=uplink_retries,
                         retry_backoff=retry_backoff, recorder=recorder)
        if buffer_size < 1:
            raise ValueError("buffer_size must be ≥ 1")
        if max_version_lag < 1:
            raise ValueError("max_version_lag must be ≥ 1")
        self.buffer_size = buffer_size
        self.staleness_alpha = staleness_alpha
        self.max_version_lag = max_version_lag
        self._version = 0
        self._snapshots: Dict[int, Any] = {}  # version → global lora
        # in flight: (arrival time, client, launch version)
        self._inflight: List[Tuple[float, ClientInfo, int]] = []

    def _raw_weight(self, client: ClientInfo, staleness: int) -> float:
        n = (float(client.num_examples)
             if self.policy.weighting == "examples" else 1.0)
        return n * (1.0 + staleness) ** (-self.staleness_alpha)

    def run_round(self, round_id: int, train_fn: TrainFn, global_lora: Any
                  ) -> RoundOutcome:
        pol = self.policy
        self._ensure_spec(global_lora)
        opened = self.clock.now()
        self._snapshots[self._version] = global_lora
        self.rec.event("commit.open", cat="fedsrv", round=round_id,
                       version=self._version, inflight=len(self._inflight))

        # launch newly sampled clients at the current version
        participants = self.registry.sample_round(round_id, pol.participation,
                                                  max(1, pol.min_quorum))
        sampled = [c.client_id for c in participants]
        dropped_out: List[int] = []
        busy = {c.client_id for _, c, _ in self._inflight}
        launched = 0
        for c in participants:
            if c.client_id in busy:
                continue  # still running an older version's assignment
            if self.stragglers.dropped(round_id, c):
                dropped_out.append(c.client_id)
                self.rec.event("client.dropout", cat="fedsrv", round=round_id,
                               client=c.client_id)
                continue
            t = opened + self.stragglers.latency(round_id, c)
            self._inflight.append((t, c, self._version))
            launched += 1
        self._inflight.sort(key=lambda e: (e[0], e[1].client_id))

        take = min(self.buffer_size, len(self._inflight))
        if take == 0:
            # every sampled client dropped out and nothing is in flight: an
            # empty commit keeps the version (and the trainer its global)
            return RoundOutcome(
                round_id=round_id, sampled=sampled, delivered=[],
                dropped_out=dropped_out, dropped_deadline=[], weights=None,
                opened_at=opened, closed_at=self.clock.now(),
                comm=self.ledger.round_totals(round_id))
        batch, self._inflight = self._inflight[:take], self._inflight[take:]
        self._open_sink([c.client_id for _, c, _ in batch], round_id,
                        deadline=self._version + self.max_version_lag,
                        now=self._version)

        delivered: List[Delivery] = []
        quarantined: List[Tuple[int, str]] = []
        retries = 0
        with self.rec.span("commit.collect", cat="fedsrv", round=round_id,
                           version=self._version, take=take):
            for t, c, v in batch:
                start = self._snapshots[v]
                self._record_downlink(start, round_id, c.client_id)
                with self.rec.span("client.train", cat="fedsrv",
                                   round=round_id, client=c.client_id,
                                   launch_version=v):
                    lora_c = train_fn(c, start, round_id)
                # the raw weight streams at uplink: commits drain after the
                # version they discount against, so the staleness is known
                res = self._uplink(lora_c, round_id, c.client_id,
                                   weight=self._raw_weight(
                                       c, self._version - v))
                self.clock.advance_to(t)
                retries += res.retries
                if res.ok:
                    delivered.append(Delivery(client=c, lora=res.tree,
                                              launched_at=t, arrived_at=t,
                                              staleness=self._version - v))
                else:
                    quarantined.append((c.client_id, res.reason))
        delivered.sort(key=lambda d: d.client.client_id)

        if not delivered:
            # every buffered delivery was quarantined: keep the version,
            # evict the set, carry the global forward
            self._evict_sink_round(round_id, "degraded: commit buffer fully "
                                   "quarantined")
            self._note_degraded(round_id, 0, take, len(quarantined))
            return RoundOutcome(
                round_id=round_id, sampled=sampled, delivered=[],
                dropped_out=dropped_out, dropped_deadline=[], weights=None,
                opened_at=opened, closed_at=self.clock.now(),
                comm=self.ledger.round_totals(round_id),
                quarantined=quarantined, degraded=True, retries=retries)

        # example count × staleness discount, renormalised: the weighted
        # identity stays exact for any normalised weights
        raw = [self._raw_weight(d.client, d.staleness) for d in delivered]
        total = sum(raw)
        weights = [x / total for x in raw]

        self._version += 1
        # free the snapshots no in-flight launch needs (the previous
        # version's is kept)
        live = {v for _, _, v in self._inflight} | {self._version}
        for v in list(self._snapshots):
            if v not in live and v != self._version - 1:
                del self._snapshots[v]

        stale = [d.staleness for d in delivered]
        if self.rec.enabled:
            self.rec.hist("fedsrv.commit_staleness").observe(max(stale))
            self.rec.round_set(round_id, sampled=len(participants),
                               delivered=len(delivered),
                               dropped_out=len(dropped_out),
                               quarantined=len(quarantined),
                               retries=retries, launched=launched,
                               inflight=len(self._inflight),
                               version=self._version,
                               staleness_max=max(stale),
                               staleness_mean=round(
                                   sum(stale) / len(stale), 3),
                               opened_at=round(opened, 3),
                               closed_at=round(self.clock.now(), 3))
        return RoundOutcome(
            round_id=round_id, sampled=sampled, delivered=delivered,
            dropped_out=dropped_out, dropped_deadline=[], weights=weights,
            opened_at=opened, closed_at=self.clock.now(),
            comm=self.ledger.round_totals(round_id),
            quarantined=quarantined, retries=retries)
