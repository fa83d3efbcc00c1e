"""The weighted round close over stacked client buffers, and its chunked
streaming mode.

Counterpart of ``repro/core/engine.py`` for every engine method: ``fedex``
(average assignment), ``fedex_svd`` (rank-r' truncated residual),
``reinit`` and ``keep_local`` (Table 5's assignments) and ``hetero``
(heterogeneous client ranks):

* :class:`RoundBuffers` — preallocated ``(C_max, …)`` device stacks per
  adapter leaf in a ring of ``depth`` rotating sets: ``begin_round`` opens a
  fresh zero set (sets are never reused across rounds), ``write_flat`` copies
  one client's uplink into its lane, ``take`` pops the oldest open round for
  its close. At most ``depth`` rounds may be open; a full ring evicts the
  rounds whose deadline has passed, and drops late, replayed and
  duplicate writes.
* :class:`DeferredDivergence` — the §6 divergence leaves the close as a
  device scalar; the host sync happens only in :meth:`~DeferredDivergence.
  resolve`, which the trainer calls at the next round boundary.
* :func:`make_close_fn` / :class:`RoundCloseEngine` — the close. Uniform
  full-participation fedex, reinit, keep_local and hetero rounds compose the
  eager operators (:mod:`repro_torch.core.aggregation`,
  :mod:`repro_torch.core.hetero`) exactly as the reference's uniform
  branches do (their bitwise contract). Weighted, partial and ragged-rank
  rounds, and every fedex_svd round, go through the weight vector, zeros
  masking non-delivered lanes: on CUDA tensors through the kernels
  (``factor_mean``, ``fedex_fold``, ``product_fold``, ``perclient_fold``,
  ``hetero_fold``; the counterpart of the reference's ``pallas`` backend),
  on the CPU through the same closes on the kernels' plain PyTorch versions
  (its ``jnp`` backend).
* chunked streaming mode (``chunk > 0``): rounds of more than ``chunk``
  candidates stage uplinks chunk by chunk and fold each chunk, in slot
  order, into running accumulators at ingest (one grouped ``factor_mean``
  launch a chunk and ``product_accum`` on the kernel backend); the close normalises them and
  finishes in plain PyTorch, folding into W0 (or each delivered client's
  own base) in place;
* the factored machinery of the fedex_svd and hetero closes
  (:func:`factored_truncated_residual`, :func:`factored_truncated_product`):
  Eckart–Young truncations from two (C·r)² Grams, the dense m×n matrix
  never formed.

JAX donates the W0 leaves and stacks to its close program; here the kernel
closes write the fold into W0's own storage instead, so a caller must treat
the ``params`` it passes to :meth:`RoundCloseEngine.close` (and the bases of
the delivered clients it passes to ``close_keep_local`` / ``close_hetero``)
as consumed: clients must not share W0 leaves.

Observability (``recorder``, :mod:`repro_torch.obs`): the close's host
launches are the ``close.dispatch`` span (``close_dispatch_us``), the wait
for the device is the ``divergence.resolve`` span in
:meth:`DeferredDivergence.resolve` (``close_block_us``), and the ring
records its begin / write / take / evict, its drops and the chunked ring's
partial folds. ``peak_bytes`` is the reference's analytic model of a
close's live device bytes (inputs, outputs and materialised intermediates),
the same formula on every backend. The reference also counts its
compiled-program cache (``engine.compile_*``, ``close.compile_evicted``,
``engine.compile_cache_size`` and the rounds' ``compile_miss``); the port
compiles no close program, so these have no counterpart here. Nothing
recorded waits for the device: the close makes no host sync with obs on or
off.

The ring is locked (an ``RLock``): the HTTP service
(:mod:`repro_torch.fedsrv.server`) decodes uplinks on its handler threads,
so a write races ``begin_round`` / ``evict`` / ``take``; decode and
validation stay parallel, and only the lane copy and the round bookkeeping
serialise.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.kernels import (factor_mean_group, factor_mean_plain,
                                 fedex_fold, fedex_fold_plain, hetero_fold,
                                 hetero_fold_plain, perclient_fold,
                                 perclient_fold_plain, product_accum,
                                 product_accum_plain, product_fold,
                                 product_fold_plain)
from repro_torch.obs import NULL
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

Params = Dict[str, Any]

BACKENDS = ("auto", "plain", "kernels")
RING_MEMORY = 64  # evicted and closed round ids the ring remembers
ENGINE_METHODS = ("fedex", "fedex_svd", "reinit", "keep_local", "hetero")


class DeferredDivergence:
    """§6 divergence as a device scalar with the host sync deferred to
    :meth:`resolve` (or ``float()``), which caches the value. With a live
    ``recorder`` the resolution is the ``divergence.resolve`` span: the
    close's wait for the device (``close_block_us``)."""

    __slots__ = ("_raw", "_value", "round_id", "_recorder")

    def __init__(self, raw: torch.Tensor, round_id=None, recorder=None):
        self._raw = raw
        self._value: Optional[float] = None
        self.round_id = round_id
        self._recorder = recorder

    @property
    def resolved(self) -> bool:
        return self._value is not None

    def resolve(self) -> float:
        """Block on the device value (the only host sync) and cache it."""
        if self._value is None:
            rec = self._recorder
            if rec is not None and rec.enabled:
                t0 = time.perf_counter_ns()
                with rec.span("divergence.resolve", cat="engine",
                              round=self.round_id):
                    self._value = float(self._raw)
                block_us = (time.perf_counter_ns() - t0) / 1e3
                rec.hist("engine.close_block_us").observe(block_us)
                if self.round_id is not None:
                    rec.round_set(self.round_id,
                                  close_block_us=round(block_us, 1),
                                  divergence=self._value)
            else:
                self._value = float(self._raw)
            self._raw = None  # drop the device reference
        return self._value

    def __float__(self) -> float:
        return self.resolve()


# --------------------------------------------------------------------------
# factor specs: pair every lora {a, b} node with its W0 leaf in params
# --------------------------------------------------------------------------

class FactorSpec:
    """One adapted matrix: the lora factor node at ``key`` and the W0 leaf
    it updates, at the same path in params: ``{key}/kernel`` for a
    projection module (``has_kernel``), the raw tensor ``{key}`` for a MoE
    expert stack. Leading axes before the trailing (m, n) are stacked layers
    (and experts)."""

    def __init__(self, key: str, has_kernel: bool, w0_shape: Tuple[int, ...],
                 w0_dtype, a_shape: Tuple[int, ...],
                 b_shape: Tuple[int, ...]):
        self.key = key
        self.has_kernel = has_kernel
        self.w0_shape = w0_shape
        self.w0_dtype = w0_dtype
        self.a_shape = a_shape
        self.b_shape = b_shape


def build_factor_specs(params: Params, lora: Params) -> List[FactorSpec]:
    """Walk the adapter tree against params, one spec per {a, b} node."""
    specs: List[FactorSpec] = []

    def walk(prefix: List[str], p: Any, l: Any) -> None:
        if isinstance(l, dict) and set(l.keys()) >= {"a", "b"}:
            has_kernel = isinstance(p, dict) and "kernel" in p
            w0 = p["kernel"] if has_kernel else p
            specs.append(FactorSpec("/".join(prefix), has_kernel,
                                    tuple(w0.shape), w0.dtype,
                                    tuple(l["a"].shape),
                                    tuple(l["b"].shape)))
            return
        if isinstance(l, dict):
            for k in l:
                if isinstance(p, dict) and k in p:
                    walk(prefix + [k], p[k], l[k])

    walk([], params, lora)
    if not specs:
        raise ValueError("no adapter factors found — empty lora tree?")
    return specs


def _get_path(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _set_path(tree: Params, path: str, value: Any) -> Params:
    """Functional nested-dict update (copies only the spine)."""
    parts = path.split("/")
    out = dict(tree)
    node = out
    for p in parts[:-1]:
        node[p] = dict(node[p])
        node = node[p]
    node[parts[-1]] = value
    return out


def w0_leaf(spec: FactorSpec, params: Params) -> torch.Tensor:
    """The W0 leaf ``spec`` adapts: the module's ``kernel`` child, or the
    raw expert tensor."""
    node = _get_path(params, spec.key)
    return node["kernel"] if spec.has_kernel else node


def collect_w0_leaves(specs: Sequence[FactorSpec],
                      params: Params) -> Dict[str, torch.Tensor]:
    """key → the adapted W0 leaf (:func:`w0_leaf`)."""
    return {s.key: w0_leaf(s, params) for s in specs}


def fold_back_w0(specs: Sequence[FactorSpec], params: Params,
                 new_w0: Dict[str, torch.Tensor]) -> Params:
    """Write the close's W0 leaves back into the params tree (spine copy).
    Inverse of :func:`collect_w0_leaves`."""
    new_params = params
    for s in specs:
        node = (dict(_get_path(params, s.key), kernel=new_w0[s.key])
                if s.has_kernel else new_w0[s.key])
        new_params = _set_path(new_params, s.key, node)
    return new_params


# --------------------------------------------------------------------------
# streaming round buffers (depth-2 ring)
# --------------------------------------------------------------------------

def _ring_locked(fn):
    """Serialise a :class:`RoundBuffers` method on the ring's ``RLock``
    (re-entrant: ``begin_round`` evicts under its own lock, and a chunk
    fold reads the ring back)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._ring_lock:
            return fn(self, *args, **kwargs)
    return wrapper


class RoundBuffers:
    """Preallocated ``(C_max, …)`` f32 device stacks, one per adapter leaf,
    written lane by lane, in a ring of at most ``depth`` open rounds.

    * every ``begin_round`` allocates a fresh zero set — a set is never
      reused, so an in-flight close never sees the next round's writes;
    * opening more than ``depth`` rounds raises (never a silent overwrite),
      unless open rounds carry a ``deadline`` that has passed at the
      caller's ``now`` (sim-seconds for the sync coordinator, commit
      versions for FedBuff): those are evicted first;
    * a write is routed by its round id and lands at most once: a write
      for an evicted round (``stale_drops``), for a closed one
      (``replay_drops``) or a second write of a (client, round) lane
      (``duplicate_drops``) returns ``False`` and writes nothing; the ring
      remembers the last 64 evicted and 64 closed round ids;
      lanes nobody wrote stay zero, and the weight vector masks them;
    * each round keeps a per-slot int32 rank vector: the true adapter rank
      a hetero uplink declared at :meth:`write` (its payload zero-padded to
      the template rank), −1 where none was declared (full rank).

    Chunked mode (``chunk > 0``): a round with more than ``chunk`` candidate
    lanes stages its uplinks in ``(chunk, …)`` stacks, one per chunk of
    consecutive slots, together with each uplink's RAW ingest weight. Each
    chunk that fills, and is next in SLOT order, folds at once into the
    round's running accumulators through ``on_chunk(acc, chunk_stacks,
    raw_weights, round_id, k)``, while later uplinks keep arriving. Chunk k
    never folds before chunks < k, so the fold sequence, and with it every
    accumulator bit, depends on the slot assignment and the payloads, never
    on the arrival order. :meth:`take_chunked` folds the chunks that never
    filled (unwritten rows hold zeros and zero weight) and hands over the
    accumulators. ``retain_chunks`` keeps the folded chunks for closes that
    read them again (keep_local, fedex_svd, hetero). A round that fits in one
    chunk takes the stacked path (the "auto" rule ``0 < chunk <
    len(slots)``). The reference stages chunks in host numpy; this ring
    stages each chunk on its device (one chunk of paper-llama3.2-3b uplinks
    is 4 × 9.18 MB), and :meth:`state_dict` copies a round's device state
    to the host for a checkpoint.
    """

    def __init__(self, lora_template: Params, c_max: int, depth: int = 2,
                 device: Optional[torch.device] = None, *, chunk: int = 0,
                 on_chunk=None, retain_chunks: bool = False, recorder=None):
        if c_max < 1:
            raise ValueError("c_max must be ≥ 1")
        if depth < 1:
            raise ValueError("depth must be ≥ 1")
        if chunk < 0:
            raise ValueError(f"chunk must be ≥ 0, got {chunk}")
        if chunk > 0 and on_chunk is None:
            raise ValueError("a chunked ring needs an on_chunk fold callback")
        self.c_max = c_max
        self.depth = depth
        self.chunk = chunk
        self.on_chunk = on_chunk
        self.retain_chunks = retain_chunks
        self.partial_folds = 0  # eager (mid-round) chunk folds, all rounds
        flat = flatten_with_paths(lora_template)
        self._shapes = {p: tuple(x.shape) for p, x in flat.items()}
        self.r_max = agg._factor_rank(lora_template)  # the template rank
        self.device = (next(iter(flat.values())).device if device is None
                       else device)
        # round_id → {"slots": cid→lane, "written": cid→lane, "deadline",
        #             "chunked": bool, "ranks": per-slot int32, then
        #             "stacks" or chunk state}
        self._open: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        # the last RING_MEMORY evicted (id → reason) and closed round ids: a
        # late or replayed uplink for one of them is dropped, not an error
        self._evicted: "OrderedDict[Any, str]" = OrderedDict()
        self._closed: "OrderedDict[Any, bool]" = OrderedDict()
        self.evictions = 0
        self.stale_drops = 0      # writes for an evicted round
        self.replay_drops = 0     # writes for a closed round
        self.duplicate_drops = 0  # second write of a (client, round) lane
        self._auto = 0
        self.rec = recorder if recorder is not None else NULL
        self._ring_lock = threading.RLock()

    def _alloc(self, lanes: int) -> Dict[str, torch.Tensor]:
        return {p: torch.zeros((lanes,) + s, dtype=torch.float32,
                               device=self.device)
                for p, s in self._shapes.items()}

    def _entry(self, round_id=None) -> Tuple[Any, Dict[str, Any]]:
        if not self._open:
            raise RuntimeError("no open round — begin_round() first")
        if round_id is None:
            rid = next(iter(self._open))
            return rid, self._open[rid]
        if round_id not in self._open:
            raise KeyError(f"round {round_id!r} is not open "
                           f"(open: {list(self._open)})")
        return round_id, self._open[round_id]

    @_ring_locked
    def begin_round(self, slots: Dict[int, int], round_id=None, *,
                    deadline: Optional[float] = None,
                    now: Optional[float] = None):
        """Open a round: ``slots`` maps client_id → lane over the round's
        candidates. Returns the round id (auto-assigned when omitted).

        ``deadline`` marks when this round becomes evictable and ``now`` is
        the current value, on the caller's monotonic scale: a full ring
        first evicts the open rounds whose deadline is ≤ ``now``; without
        ``now``, or with nothing expired, a full ring raises. Reopening a
        remembered id makes it a fresh round (its evicted/closed memory is
        forgotten)."""
        if len(slots) > self.c_max:
            raise ValueError(f"{len(slots)} candidates > C_max={self.c_max}")
        if any(not 0 <= s < self.c_max for s in slots.values()):
            raise ValueError(f"slot out of range in {slots}")
        if round_id is None:
            round_id = f"_auto{self._auto}"
            self._auto += 1
        if round_id in self._open:
            raise ValueError(f"round {round_id!r} is already open")
        self._evicted.pop(round_id, None)
        self._closed.pop(round_id, None)
        if len(self._open) >= self.depth and now is not None:
            for rid in [r for r, e in self._open.items()
                        if e["deadline"] is not None and e["deadline"] <= now]:
                self.evict(rid, reason=f"deadline {self._open[rid]['deadline']}"
                                       f" ≤ now {now}")
        if len(self._open) >= self.depth:
            raise RuntimeError(
                f"all {self.depth} buffer sets are in flight (open rounds: "
                f"{list(self._open)}) — take() the oldest before opening "
                "another, or give open rounds a deadline so a full ring can "
                "evict them")
        chunked = 0 < self.chunk < len(slots)
        entry: Dict[str, Any] = {"slots": dict(slots), "written": {},
                                 "deadline": deadline, "chunked": chunked}
        if chunked:
            num_chunks = max(slots.values()) // self.chunk + 1
            expected = [0] * num_chunks
            for lane in slots.values():
                expected[lane // self.chunk] += 1
            nslots = num_chunks * self.chunk
            entry.update(chunks={}, retained={}, acc=None,
                         w=np.zeros(nslots, np.float32),
                         ranks=np.full(nslots, -1, np.int32), next_chunk=0,
                         num_chunks=num_chunks, expected=expected,
                         filled=[0] * num_chunks, eager_folds=0)
        else:
            entry.update(stacks=self._alloc(self.c_max),
                         ranks=np.full(self.c_max, -1, np.int32))
        self._open[round_id] = entry
        if self.rec.enabled:
            self.rec.event("ring.begin", cat="ring", round=round_id,
                           lanes=len(slots), deadline=deadline,
                           chunked=chunked)
            self.rec.gauge("ring.occupancy").set(len(self._open))
        return round_id

    @staticmethod
    def _remember(memory: "OrderedDict[Any, Any]", rid, value) -> None:
        memory[rid] = value
        while len(memory) > RING_MEMORY:
            memory.popitem(last=False)

    @_ring_locked
    def evict(self, round_id, reason: str = "explicit") -> Dict[int, int]:
        """Drop an open round without closing it (its stacks are
        discarded, and a late uplink for it is dropped); returns its
        delivered {client_id: lane} map."""
        rid, e = self._entry(round_id)
        del self._open[rid]
        self._remember(self._evicted, rid, reason)
        self.evictions += 1
        if self.rec.enabled:
            self.rec.counter("ring.evictions").inc()
            self.rec.event("ring.evict", cat="ring", round=rid, reason=reason,
                           delivered=len(e["written"]), lanes=len(e["slots"]))
            self.rec.gauge("ring.occupancy").set(len(self._open))
        return dict(e["written"])

    def _close(self, rid, **args) -> Dict[str, Any]:
        self._remember(self._closed, rid, True)
        e = self._open.pop(rid)
        if self.rec.enabled:
            self.rec.event("ring.take", cat="ring", round=rid,
                           delivered=len(e["written"]), lanes=len(e["slots"]),
                           **args)
            self.rec.gauge("ring.occupancy").set(len(self._open))
        return e

    def _drop(self, kind: str, round_id, client_id: int) -> bool:
        """Count (and record) a refused write; returns ``False``."""
        setattr(self, kind + "_drops", getattr(self, kind + "_drops") + 1)
        if self.rec.enabled:
            self.rec.counter(f"ring.{kind}_drops").inc()
            self.rec.event(f"ring.{kind}_drop", cat="ring", round=round_id,
                           client=client_id)
        return False

    @_ring_locked
    def write_flat(self, client_id: int, flat: Dict[str, torch.Tensor],
                   round_id=None, *, weight: Optional[float] = None,
                   rank: Optional[int] = None) -> bool:
        """Copy one client's adapter leaves (path → tensor) into its lane of
        the named round (default: the oldest open round with a lane for
        this client). Returns ``False``, and writes nothing, for a round
        that was evicted or closed and for a duplicate (client, round)
        write; an id the ring never saw (or forgot) raises ``KeyError``.
        Only an explicit ``round_id`` lets a late uplink be recognised:
        the coordinators route every write by its payload's round.

        ``weight`` is the uplink's RAW (unnormalised) aggregation weight,
        1.0 when omitted: a chunked round folds it in at ingest, so the
        caller must stream the weighting it will close with (the close
        checks and raises on a mismatch); a stacked round ignores it.
        ``rank`` is the uplink's true adapter rank (a hetero payload
        zero-padded to the template rank); ``None`` means full rank."""
        if round_id is None:
            round_id = next((r for r, e in self._open.items()
                             if client_id in e["slots"]), None)
            if round_id is None:
                raise KeyError(f"client {client_id} has no lane in any open "
                               f"round (open: {list(self._open)})")
        if round_id not in self._open:
            if round_id in self._evicted:
                return self._drop("stale", round_id, client_id)
            if round_id in self._closed:
                return self._drop("replay", round_id, client_id)
        rid, e = self._entry(round_id)
        if rank is not None and not 1 <= rank <= self.r_max:
            raise ValueError(f"uplink rank {rank} outside "
                             f"[1, r_max={self.r_max}]")
        if client_id in e["written"]:
            return self._drop("duplicate", round_id, client_id)
        if flat.keys() != self._shapes.keys():
            raise ValueError(
                f"uplink tree mismatch (missing="
                f"{sorted(set(self._shapes) - set(flat))}, extra="
                f"{sorted(set(flat) - set(self._shapes))})")
        for p, shape in self._shapes.items():
            if tuple(flat[p].shape) != shape:
                raise ValueError(f"{p}: shape {tuple(flat[p].shape)} != "
                                 f"template {shape}")
        slot = e["slots"][client_id]
        # the overlap invariant's witness: round N+1's writes land inside
        # round N's close window
        with self.rec.span("ring.write", cat="ring", round=rid,
                           client=client_id):
            if e["chunked"]:
                k, row = divmod(slot, self.chunk)
                if k not in e["chunks"]:
                    e["chunks"][k] = self._alloc(self.chunk)
                stacks = e["chunks"][k]
                e["w"][slot] = 1.0 if weight is None else weight
                e["filled"][k] += 1
            else:
                stacks, row = e["stacks"], slot
            with torch.no_grad():
                for p in self._shapes:
                    stacks[p][row].copy_(flat[p])
        e["written"][client_id] = slot
        if rank is not None:
            e["ranks"][slot] = rank
        if e["chunked"]:
            self._cascade(rid, e)
        return True

    def write(self, client_id: int, lora_tree: Params, round_id=None, *,
              weight: Optional[float] = None,
              rank: Optional[int] = None) -> bool:
        return self.write_flat(client_id, flatten_with_paths(lora_tree),
                               round_id, weight=weight, rank=rank)

    @_ring_locked
    def ranks_in(self, round_id=None) -> np.ndarray:
        """The round's (C_max,) per-slot rank vector (−1 = none declared)."""
        ranks = self._entry(round_id)[1]["ranks"]
        out = np.full(self.c_max, -1, np.int32)
        n = min(self.c_max, len(ranks))
        out[:n] = ranks[:n]
        return out

    @_ring_locked
    def chunk_ranks(self, round_id, k: int) -> np.ndarray:
        """Chunk k's per-slot rank vector (−1 = full rank) of a chunked
        round: the hetero partial fold masks padded columns with it."""
        ranks = self._entry(round_id)[1]["ranks"]
        return ranks[k * self.chunk:(k + 1) * self.chunk].copy()

    # -- chunked fold cascade ----------------------------------------------
    def _cascade(self, rid, e) -> None:
        """Fold every complete chunk that is next in slot order; a full
        chunk whose predecessor is not folded yet waits its turn."""
        while (e["next_chunk"] < e["num_chunks"]
               and e["filled"][e["next_chunk"]]
               == e["expected"][e["next_chunk"]]):
            self._fold_next(rid, e, eager=True)

    def _fold_next(self, rid, e, *, eager: bool) -> None:
        k = e["next_chunk"]
        stacks = e["chunks"].pop(k, None)
        if stacks is None:
            # nothing of this chunk was delivered: zero rows with zero
            # weights fold as an exact no-op
            stacks = self._alloc(self.chunk)
        w = e["w"][k * self.chunk:(k + 1) * self.chunk].copy()
        t0 = time.perf_counter_ns()
        # eager folds are the chunked ring's overlap witnesses; a close's
        # flush of the trailing chunks has a span name of its own
        span = "close.partial_fold" if eager else "close.chunk_flush"
        with self.rec.span(span, cat="engine", round=rid, chunk=k):
            e["acc"] = self.on_chunk(e["acc"], stacks, w, rid, k)
        if self.retain_chunks:
            e["retained"][k] = stacks
        e["next_chunk"] = k + 1
        if eager:
            e["eager_folds"] += 1
            self.partial_folds += 1
        if self.rec.enabled:
            self.rec.hist("close.chunk_flush_us").observe(
                (time.perf_counter_ns() - t0) / 1e3)
            if eager:
                self.rec.counter("close.partial_folds").inc()

    @_ring_locked
    def is_chunked(self, round_id=None) -> bool:
        return bool(self._entry(round_id)[1]["chunked"])

    @property
    @_ring_locked
    def open_rounds(self) -> List[Any]:
        return list(self._open)

    @_ring_locked
    def delivered_in(self, round_id=None) -> Dict[int, int]:
        return dict(self._entry(round_id)[1]["written"])

    @_ring_locked
    def lanes(self, round_id=None) -> Dict[int, int]:
        """client_id → lane for all of a round's candidates."""
        return dict(self._entry(round_id)[1]["slots"])

    @_ring_locked
    def slot_of(self, client_id: int, round_id=None) -> int:
        return self._entry(round_id)[1]["slots"][client_id]

    @_ring_locked
    def take(self, round_id=None) -> Dict[str, torch.Tensor]:
        """Pop the oldest (or named) open round and hand over its stacks."""
        rid, e = self._entry(round_id)
        if e["chunked"]:
            raise RuntimeError(f"round {rid!r} streams in chunks — close it "
                               "via take_chunked()")
        return self._close(rid)["stacks"]

    @_ring_locked
    def take_chunked(self, round_id=None) -> Tuple[Any, Dict[str, Any]]:
        """Fold the remaining chunks in slot order, pop the round and return
        ``(round_id, entry)``: the entry holds the accumulators (``acc``),
        the raw ingest weights (``w``), the retained chunks and the
        delivery bookkeeping."""
        rid, e = self._entry(round_id)
        if not e["chunked"]:
            raise RuntimeError(f"round {rid!r} is stacked — close it via "
                               "take()")
        while e["next_chunk"] < e["num_chunks"]:
            self._fold_next(rid, e, eager=False)
        return rid, self._close(rid, chunked=True,
                                partial_folds=e["eager_folds"])

    # -- checkpoint / resume -----------------------------------------------
    @_ring_locked
    def state_dict(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """``(meta, arrays)``: the ring's JSON-able bookkeeping (open
        rounds' slots, deliveries, deadlines and fold-cascade positions, the
        evicted / closed memories, the drop counters) and host copies of its
        open rounds' arrays, keyed ``ring/{round}/…``: a stacked round's
        stacks, a chunked round's staged and retained chunks, running
        accumulators and raw ingest weights, and every round's rank vector.
        At a round boundary the ring is normally empty."""
        meta: Dict[str, Any] = {
            "open": [], "evicted": list(self._evicted.items()),
            "closed": list(self._closed), "evictions": self.evictions,
            "stale_drops": self.stale_drops,
            "replay_drops": self.replay_drops,
            "duplicate_drops": self.duplicate_drops,
            "partial_folds": self.partial_folds, "auto": self._auto}
        arrays: Dict[str, np.ndarray] = {}

        def put(key: str, x) -> None:
            arrays[key] = (x.detach().cpu().numpy().copy()
                           if torch.is_tensor(x) else np.array(x))

        for rid, e in self._open.items():
            entry = {"round": rid, "deadline": e["deadline"],
                     "chunked": e["chunked"],
                     "slots": [[c, s] for c, s in e["slots"].items()],
                     "written": [[c, s] for c, s in e["written"].items()]}
            put(f"ring/{rid}/_ranks", e["ranks"])
            if e["chunked"]:
                entry.update(next_chunk=e["next_chunk"],
                             num_chunks=e["num_chunks"],
                             expected=list(e["expected"]),
                             filled=list(e["filled"]),
                             eager_folds=e["eager_folds"],
                             pending_chunks=sorted(e["chunks"]),
                             retained_chunks=sorted(e["retained"]),
                             acc_keys=sorted(e["acc"] or {}))
                put(f"ring/{rid}/_w", e["w"])
                for prefix, bufs in (("_chunk", e["chunks"]),
                                     ("_ret", e["retained"])):
                    for k, buf in bufs.items():
                        for p, x in buf.items():
                            put(f"ring/{rid}/{prefix}{k}/{p}", x)
                for name, x in (e["acc"] or {}).items():
                    put(f"ring/{rid}/_acc/{name}", x)
            else:
                for p, x in e["stacks"].items():
                    put(f"ring/{rid}/{p}", x)
            meta["open"].append(entry)
        return meta, arrays

    @_ring_locked
    def load_state(self, meta: Dict[str, Any], arrays: Dict[str, Any]
                   ) -> None:
        """Restore a :meth:`state_dict` snapshot (its arrays numpy or
        tensors on any device): the open rounds' arrays are copied onto this
        ring's device in float32, so the remaining writes, folds and the
        close replay exactly as they would have."""
        def dev(key: str) -> torch.Tensor:
            x = arrays[key]
            t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            return t.to(device=self.device, dtype=torch.float32, copy=True)

        def host(key: str, dtype) -> np.ndarray:
            x = arrays[key]
            return np.array(x.cpu() if torch.is_tensor(x) else x, dtype=dtype)

        self._open = OrderedDict()
        for entry in meta["open"]:
            rid = entry["round"]
            e: Dict[str, Any] = {
                "slots": {int(c): int(s) for c, s in entry["slots"]},
                "written": {int(c): int(s) for c, s in entry["written"]},
                "deadline": entry["deadline"], "chunked": entry["chunked"],
                "ranks": host(f"ring/{rid}/_ranks", np.int32)}
            if e["chunked"]:
                def bufs(prefix, ks):
                    return {int(k): {p: dev(f"ring/{rid}/{prefix}{k}/{p}")
                                     for p in self._shapes} for k in ks}

                e.update(chunks=bufs("_chunk", entry["pending_chunks"]),
                         retained=bufs("_ret", entry["retained_chunks"]),
                         acc={name: dev(f"ring/{rid}/_acc/{name}")
                              for name in entry["acc_keys"]} or None,
                         w=host(f"ring/{rid}/_w", np.float32),
                         next_chunk=int(entry["next_chunk"]),
                         num_chunks=int(entry["num_chunks"]),
                         expected=[int(x) for x in entry["expected"]],
                         filled=[int(x) for x in entry["filled"]],
                         eager_folds=int(entry.get("eager_folds", 0)))
            else:
                e["stacks"] = {p: dev(f"ring/{rid}/{p}")
                               for p in self._shapes}
            self._open[rid] = e
        self._evicted = OrderedDict((rid, reason)
                                    for rid, reason in meta["evicted"])
        self._closed = OrderedDict((rid, True) for rid in meta["closed"])
        self.evictions = int(meta["evictions"])
        self.stale_drops = int(meta["stale_drops"])
        self.replay_drops = int(meta["replay_drops"])
        self.duplicate_drops = int(meta["duplicate_drops"])
        self.partial_folds = int(meta["partial_folds"])
        self._auto = int(meta["auto"])


# --------------------------------------------------------------------------
# the close
# --------------------------------------------------------------------------

def _stacked_residual_factors(a_stack: torch.Tensor, b_stack: torch.Tensor,
                              u: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_c u_c·a_c b_c − ā b̄ = L @ R with L = [u_0·a_0 | … ] (…, m, C·r) and
    R = [b_0 − b̄ ; …] (…, C·r, n), b̄ = Σ_c u_c·b_c. Lanes with u_c = 0 are
    selected away (zeroed) first, so whatever they hold adds exactly 0."""
    c = a_stack.shape[0]
    live = (u != 0).reshape((c,) + (1,) * (a_stack.ndim - 1))
    a = torch.where(live, a_stack.float(), 0.0)
    b = torch.where(live, b_stack.float(), 0.0)
    bbar = torch.einsum("c,c...rn->...rn", u, b)
    L = torch.cat([u[i] * a[i] for i in range(c)], dim=-1)
    R = torch.cat([b[i] - bbar for i in range(c)], dim=-2)
    return L, R


def _dev_fro_scaled(a_stack: torch.Tensor, b_stack: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Scaled Frobenius norm of Σu_c·a_c b_c − ā b̄ via the factored Grams —
    never materialises the (…, m, n) deviation. Returns (…,)."""
    L, R = _stacked_residual_factors(a_stack, b_stack, u)
    gl = torch.einsum("...mi,...mj->...ij", L, L)
    gr = torch.einsum("...in,...jn->...ij", R, R)
    fro_sq = torch.clamp(torch.einsum("...ij,...ij->...", gl, gr), min=0.0)
    m, n = a_stack.shape[-2], b_stack.shape[-1]
    return torch.sqrt(fro_sq) / math.sqrt(m * n)


def _safe_inv_sqrt(lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ^{-1/2}, λ^{1/2}) with pseudo-inverse semantics: eigenvalues below
    the rank-detection floor (masked lanes, redundant factors) map to 0."""
    tol = lam.max(dim=-1, keepdim=True).values * (lam.shape[-1] * 1e-7)
    pos = lam > tol
    safe = torch.where(pos, lam, 1.0)
    return (torch.where(pos, torch.rsqrt(safe), 0.0),
            torch.where(pos, torch.sqrt(safe), 0.0))


def _gram_core(L: torch.Tensor, R: torch.Tensor):
    """The SVD of ΔW = L @ R through two (P, P) Grams: returns (left, u, s,
    vt, right) with ΔW = (L @ left @ u) diag(s) (vt @ right @ R), left =
    E_L Λ_L^{-1/2} and right = Λ_R^{-1/2} E_Rᵀ. Every intermediate is
    (m, P), (P, n) or (P, P); the (m, n) matrix never exists."""
    return _core_of_grams(torch.einsum("...mi,...mj->...ij", L, L),
                          torch.einsum("...in,...jn->...ij", R, R))


def _core_of_grams(gl: torch.Tensor, gr: torch.Tensor):
    """:func:`_gram_core` from the Grams G_L = LᵀL and G_R = R Rᵀ."""
    el, vl = torch.linalg.eigh(gl)
    er, vr = torch.linalg.eigh(gr)
    il, sl = _safe_inv_sqrt(el)
    ir, sr = _safe_inv_sqrt(er)
    core = (sl[..., :, None] * (vl.transpose(-1, -2) @ vr)
            * sr[..., None, :])
    u, s, vt = torch.linalg.svd(core, full_matrices=False)
    return (vl * il[..., None, :], u, s, vt,
            (vr * ir[..., None, :]).transpose(-1, -2))


def factored_truncated_residual(a_stack: torch.Tensor, b_stack: torch.Tensor,
                                weights: torch.Tensor, rank: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eckart–Young-optimal rank-``rank`` factors of the weighted residual
    Σ_c w_c a_c b_c − ā b̄ = L @ R (Eq. 15–16), without the dense (m, n)
    matrix: eigendecompose G_L = LᵀL and G_R = R Rᵀ, take the SVD of the
    P×P core Λ_L^{1/2} E_Lᵀ E_R Λ_R^{1/2}, and return

        A' = L E_L Λ_L^{-1/2} U_{:r'} Σ_{:r'}   (…, m, r')
        B' = V_{:r'}ᵀ Λ_R^{-1/2} E_Rᵀ R          (…, r', n)

    The Gram squaring costs about half the f32 digits: A' B' matches a dense
    SVD truncation to ~1e-5 relative. Eigenvector signs differ between
    LAPACK and cuSOLVER, so compare A' B', never A' or B' alone."""
    L, R = _stacked_residual_factors(a_stack, b_stack, weights)
    left, u, s, vt, right = _gram_core(L, R)
    aprime = L @ (left @ u[..., :, :rank]) * s[..., None, :rank]
    bprime = (vt[..., :rank, :] @ right) @ R
    return aprime, bprime


def factored_truncated_product(L: torch.Tensor, R: torch.Tensor, rank: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eckart–Young-optimal rank-``rank`` factors of the UNCENTERED product
    L @ R — the hetero close's truncation, shared with the eager oracle
    (:mod:`repro_torch.core.hetero`). The same Gram machinery as
    :func:`factored_truncated_residual`, with the balanced split
    A' = Q_L U √Σ, B' = √Σ Vᵀ Q_Rᵀ R, so the leading-r' slice of the factors
    is the optimal rank-r' truncation for every r' ≤ rank. Zero (padded)
    columns of L and rows of R give zero Gram eigenvalues, floored away."""
    left, u, s, vt, right = _gram_core(L, R)
    sq = torch.sqrt(torch.clamp(s[..., :rank], min=0.0))
    aprime = L @ (left @ u[..., :, :rank]) * sq[..., None, :]
    bprime = sq[..., :, None] * ((vt[..., :rank, :] @ right) @ R)
    return aprime, bprime


def _rank_mask(ranks: torch.Tensor, r: int) -> torch.Tensor:
    """(C,) int rank vector → (C, r) bool mask: column j of lane c is live
    iff j < ranks[c]. Negative ranks mean "unmasked" (full r)."""
    rk = torch.where(ranks < 0, r, ranks)
    return torch.arange(r, device=ranks.device)[None, :] < rk[:, None]


def _mask_factor_stacks(a: torch.Tensor, b: torch.Tensor, ranks: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the rank-padded columns of a (C, …, m, r) stack and the matching
    rows of its (C, …, r, n) twin. Selected, not multiplied by a 0/1 mask,
    so a masked column adds exactly 0 whatever it holds (0·NaN is NaN)."""
    c, r = a.shape[0], a.shape[-1]
    mask = _rank_mask(ranks, r)
    ma = mask.reshape((c,) + (1,) * (a.ndim - 2) + (r,))
    mb = mask.reshape((c,) + (1,) * (b.ndim - 3) + (r, 1))
    return torch.where(ma, a, 0.0), torch.where(mb, b, 0.0)


# --------------------------------------------------------------------------
# chunked closes: one chunk's L / R blocks and the in-place fold
# --------------------------------------------------------------------------

def _lane_mask(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return (w != 0).reshape((-1,) + (1,) * (ndim - 1))


def _l_block(a_chunk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(chunk, …, m, r) → (…, m, chunk·r): one chunk's weighted L columns,
    lane-major — the columns :func:`_stacked_residual_factors` gives these
    lanes, so chunk-pair Gram blocks tile the stacked (C·r)² Gram. Lanes
    with w = 0 are selected away (zeroed) first."""
    live = _lane_mask(w, a_chunk.ndim)
    la = w.reshape(live.shape) * torch.where(live, a_chunk, 0.0)
    la = torch.movedim(la, 0, -2)  # (…, m, chunk, r)
    return la.reshape(la.shape[:-2] + (-1,))


def _r_block(b_chunk: torch.Tensor, bbar: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """(chunk, …, r, n) → (…, chunk·r, n): one chunk's centred R rows b_c −
    b̄, lane-major (b_c zeroed first on lanes with w = 0)."""
    rb = torch.where(_lane_mask(w, b_chunk.ndim), b_chunk, 0.0) - bbar
    rb = torch.movedim(rb, 0, -3)  # (…, chunk, r, n)
    return rb.reshape(rb.shape[:-3] + (-1, rb.shape[-1]))


def _fold_update(w0: torch.Tensor, upd: torch.Tensor, scale: float, dtype,
                 in_place: bool) -> torch.Tensor:
    """W0 + scale·upd, rounded as two ops (the reference's order). ``upd``
    is consumed (scaled in place); with ``in_place`` the sum goes into W0's
    own storage when W0 is float32 and contiguous."""
    upd.mul_(scale)
    if in_place and w0.dtype == torch.float32 and w0.is_contiguous():
        return w0.add_(upd)
    return (w0.float() + upd).to(dtype)


def _residual(ideal: torch.Tensor, ga: torch.Tensor, gb: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ideal − ga gb, its ‖·‖_F / √(mn) per stacked layer, flattened): the
    residual and the divergence parts of a chunked close."""
    res = torch.matmul(ga, gb)
    torch.sub(ideal, res, out=res)
    m, n = res.shape[-2:]
    return res, (torch.linalg.vector_norm(res, dim=(-2, -1))
                 / math.sqrt(m * n)).reshape(-1)


# --------------------------------------------------------------------------
# the closes (one per engine method)
# --------------------------------------------------------------------------

def _slice_client_trees(specs, stacks, c_max) -> List[Params]:
    return [{s.key: {"a": stacks[s.key + "/a"][c],
                     "b": stacks[s.key + "/b"][c]} for s in specs}
            for c in range(c_max)]


def _fold_leaf(fold, w0: torch.Tensor, dtype) -> torch.Tensor:
    """Run ``fold(w0_f32, out)`` into W0's own storage when W0 is float32
    and contiguous (the in-place close), else on a float32 copy."""
    if w0.dtype == torch.float32 and w0.is_contiguous():
        return fold(w0, w0)
    return fold(w0.float().contiguous(), None).to(dtype)


def _fold_lanes(fold, lanes: List[Optional[torch.Tensor]], dtype
                ) -> List[Optional[torch.Tensor]]:
    """:func:`_fold_leaf` for a per-lane fold: into every produced lane's
    own W0 when all are float32 and contiguous, else on float32 copies."""
    if all(t is None or (t.dtype == torch.float32 and t.is_contiguous())
           for t in lanes):
        return fold(lanes, lanes)
    res = fold([None if t is None else t.float().contiguous()
                for t in lanes], None)
    return [None if x is None else x.to(dtype) for x in res]


def _uniform_close(specs, scale, w0_leaves, stacks, c_max, *,
                   in_place: bool):
    """Full-participation uniform close: the aggregation operators' ops
    over the stack lanes (``fedit_aggregate``, then ``fedex_residual``'s
    Σ_c a_c b_c / C − ā b̄ and ``apply_residual``'s W0 + s·residual), in
    the same order with the same roundings, so bitwise their composition;
    one leaf at a time, the residual accumulated in place, so that at most
    two dense (m, n) f32 temporaries of one leaf are alive (a mixtral
    expert leaf's is 12.9 GB). With ``in_place`` (the kernel backend) the
    fold is written into W0's own storage where W0 is float32 and
    contiguous, as the kernel closes write theirs."""
    new_w0, glob = {}, {}
    for s in specs:
        a, b = stacks[s.key + "/a"], stacks[s.key + "/b"]
        g = agg.fedit_aggregate([{s.key: {"a": a[c], "b": b[c]}}
                                 for c in range(c_max)])[s.key]
        acc = torch.zeros(s.w0_shape, dtype=torch.float32, device=a.device)
        for c in range(c_max):
            acc.add_(torch.matmul(a[c].float(), b[c].float()))
        acc.div_(c_max)
        acc.sub_(torch.matmul(g["a"].float(), g["b"].float()))
        acc.mul_(scale)
        w0 = w0_leaves[s.key]
        if in_place and w0.dtype == torch.float32 and w0.is_contiguous():
            new_w0[s.key] = w0.add_(acc)
        else:
            new_w0[s.key] = (w0.float() + acc).to(s.w0_dtype)
        del acc
        glob[s.key] = g
    return new_w0, glob


def _factor_means(specs, stacks, w, *, kernels: bool):
    """ā and b̄ of every adapted leaf: with ``kernels`` one grouped
    ``factor_mean`` launch over all their stacks, otherwise the plain
    version per stack."""
    keys = [s.key + f for s in specs for f in ("/a", "/b")]
    if kernels:
        means = factor_mean_group([stacks[k] for k in keys], w)
    else:
        means = [factor_mean_plain(stacks[k], w) for k in keys]
    return {s.key: {"a": means[2 * i], "b": means[2 * i + 1]}
            for i, s in enumerate(specs)}


def _weighted_close(specs, scale, w0_leaves, stacks, w, *, kernels: bool):
    """Weighted/masked close: two factor means and one fold per adapted
    leaf; zero-weight lanes vanish from every sum. With ``kernels`` the
    wrappers run (the CUDA kernels on CUDA tensors) and the fold is written
    into W0's own storage; otherwise the kernels' plain PyTorch versions."""
    new_w0 = {}
    glob = _factor_means(specs, stacks, w, kernels=kernels)
    for s in specs:
        a = stacks[s.key + "/a"]  # (C, L, m, r), read in place
        b = stacks[s.key + "/b"]
        w0 = w0_leaves[s.key]
        if not kernels:
            new_w0[s.key] = fedex_fold_plain(w0, a, b, scale, w
                                             ).to(s.w0_dtype)
            continue
        new_w0[s.key] = _fold_leaf(
            lambda x, out: fedex_fold(x, a, b, scale, weights=w, out=out),
            w0, s.w0_dtype)
    return new_w0, glob


def _svd_close(specs, scale, svd_rank, w0_leaves, stacks, w, *,
               kernels: bool):
    """Truncated-SVD close: the factored Eckart–Young residual (never
    dense), folded into W0 as the rank-r' product A' @ B' — on the kernel
    path through ``product_fold`` with A' as a one-lane (1, L, m, r') stack
    and sign vector [1]."""
    new_w0 = {}
    glob = _factor_means(specs, stacks, w, kernels=kernels)
    for s in specs:
        a = stacks[s.key + "/a"]
        b = stacks[s.key + "/b"]
        ap, bp = factored_truncated_residual(a, b, w, svd_rank)
        w0 = w0_leaves[s.key]
        one = torch.ones(1, dtype=torch.float32, device=w.device)
        if kernels:
            new_w0[s.key] = _fold_leaf(
                lambda x, out: product_fold(x, ap.unsqueeze(0),
                                            bp.unsqueeze(0), one, scale,
                                            out=out), w0, s.w0_dtype)
        else:
            new_w0[s.key] = product_fold_plain(
                w0, ap.unsqueeze(0), bp.unsqueeze(0), one, scale
            ).to(s.w0_dtype)
    return new_w0, glob


def _reinit_close(specs, scale, w0_leaves, stacks, w, c_max, uniform, *,
                  kernels: bool):
    """Reinit close (Table 5): the FULL ideal update Σ_c w_c a_c b_c folds
    into W0 (the fresh adapters carry b = 0). The uniform branch composes
    ``product_mean`` over the stack lanes (bitwise the operators); the
    others run ``product_fold`` with s = w."""
    if uniform:
        ideal = agg.product_mean(_slice_client_trees(specs, stacks, c_max))
        return {s.key: (w0_leaves[s.key].float() + scale * ideal[s.key]
                        ).to(s.w0_dtype) for s in specs}
    new_w0 = {}
    for s in specs:
        a = stacks[s.key + "/a"]
        b = stacks[s.key + "/b"]
        w0 = w0_leaves[s.key]
        if kernels:
            new_w0[s.key] = _fold_leaf(
                lambda x, out: product_fold(x, a, b, w, scale, out=out), w0,
                s.w0_dtype)
        else:
            new_w0[s.key] = product_fold_plain(w0, a, b, w, scale
                                               ).to(s.w0_dtype)
    return new_w0


def _keep_local_close(specs, scale, w0_lanes, stacks, w, c_max, uniform, *,
                      kernels: bool):
    """Keep_local close (Table 5): every delivered lane's OWN base gets its
    residual Σ_j w_j a_j b_j − a_c b_c. ``w0_lanes[key]`` lists each lane's
    W0 leaf (None for a lane not produced); the result is listed likewise.
    The uniform branch composes ``per_client_residuals`` over the stack
    lanes (bitwise the operators); the others run ``perclient_fold``."""
    if uniform:
        residuals = agg.per_client_residuals(
            _slice_client_trees(specs, stacks, c_max))
        return {s.key: [None if w0 is None else
                        (w0.float() + scale * residuals[c][s.key]
                         ).to(s.w0_dtype)
                        for c, w0 in enumerate(w0_lanes[s.key])]
                for s in specs}
    new_w0 = {}
    for s in specs:
        a = stacks[s.key + "/a"]
        b = stacks[s.key + "/b"]
        lanes = w0_lanes[s.key]
        if kernels:
            new_w0[s.key] = _fold_lanes(
                lambda xs, out: perclient_fold(xs, a, b, w, scale, out=out),
                lanes, s.w0_dtype)
        else:
            new_w0[s.key] = [None if x is None else x.to(s.w0_dtype) for x
                             in perclient_fold_plain(lanes, a, b, w, scale)]
    return new_w0


def _hetero_close(specs, scale, w0_lanes, stacks, w, ranks, c_max, uniform,
                  *, kernels: bool):
    """Heterogeneous-rank close (:mod:`repro_torch.core.hetero`'s scheme,
    engine-side): the ideal update Δ̄ = Σ_c w_c (a_c∘mask_c) b_c is
    truncated ONCE at the template rank r_max by
    :func:`factored_truncated_product`; lane c's adapters are the leading-rᵢ
    slice of that truncation and its residual Δ̄ − a'ᵢb'ᵢ folds into its OWN
    W0 (``w0_lanes`` as in :func:`_keep_local_close`), so W0_c + ΔW_c +
    a'_c b'_c = W0_c + Δ̄ for every lane. Ragged lanes ride zero-padded to
    r_max with the (C_max,) int32 rank vector ``ranks``. The uniform branch
    (full participation, uniform weights, every rank r_max) composes the
    eager oracle's op sequence; the others run ``hetero_fold``.

    Returns ``(new_w0_lanes, glob, masked_stacks)`` with ``glob[key] =
    {"a": A'(r_max), "b": B'(r_max)}`` and the rank-masked stacks for the
    divergence."""
    new_w0, glob, masked = {}, {}, {}
    for s in specs:
        a = stacks[s.key + "/a"].float()  # (C, …, m, r_max)
        b = stacks[s.key + "/b"].float()  # (C, …, r_max, n)
        r = s.a_shape[-1]
        lanes = w0_lanes[s.key]
        if uniform:
            am, bm = a, b  # every lane at full rank: no masking
            L = torch.cat([a[i] / c_max for i in range(c_max)], dim=-1)
        else:
            am, bm = _mask_factor_stacks(a, b, ranks)
            L = torch.cat([w[i] * am[i] for i in range(c_max)], dim=-1)
        R = torch.cat([bm[i] for i in range(c_max)], dim=-2)
        ap, bp = factored_truncated_product(L, R, r)
        if uniform:
            ideal, own = L @ R, ap @ bp
            new_w0[s.key] = [None if w0 is None else
                             (w0.float() + scale * (ideal - own)
                              ).to(s.w0_dtype) for w0 in lanes]
        elif kernels:
            new_w0[s.key] = _fold_lanes(
                lambda xs, out: hetero_fold(xs, a, b, w, ranks, ap, bp, scale,
                                            out=out), lanes, s.w0_dtype)
        else:
            new_w0[s.key] = [None if x is None else x.to(s.w0_dtype) for x in
                             hetero_fold_plain(lanes, a, b, w, ranks, ap, bp,
                                               scale)]
        glob[s.key] = {"a": ap, "b": bp}
        masked[s.key + "/a"] = am
        masked[s.key + "/b"] = bm
    return new_w0, glob, masked


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown engine backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    if backend == "auto":
        return "kernels" if device.type == "cuda" else "plain"
    return backend


def make_close_fn(specs: Sequence[FactorSpec], *, scale: float, c_max: int,
                  method: str = "fedex", svd_rank: int = 0,
                  backend: str = "plain"):
    """The close for one engine method: ``close(w0_leaves, stacks, weights,
    mask, *, uniform) → (new_w0_leaves, global_factors, divergence)``.

    ``weights`` is the (C_max,) f32 device vector with zeros on
    non-delivered lanes and ``mask`` its 0/1 indicator (the divergence is
    uniform over the delivered lanes); ``uniform=True`` marks a full,
    uniformly weighted round. ``backend`` is ``"kernels"`` or ``"plain"``.

    * ``fedex`` — the uniform branch composes the aggregation operators;
      otherwise ``factor_mean`` + ``fedex_fold``.
    * ``fedex_svd`` — the factored rank-``svd_rank`` truncated close (needs
      ``svd_rank ≥ 1``); every round goes through the weight vector.
    * ``reinit`` — as fedex but folds the full ideal update; ``glob={}``
      (the engine draws the fresh adapters).
    * ``keep_local`` — ``w0_leaves[key]`` lists each lane's own W0 leaf
      (None for a lane not produced), and so does the result; ``glob={}``.
    * ``hetero`` — lanes as keep_local, and the ``mask`` slot carries the
      (C_max,) int32 rank vector (0 masks a lane, −1 = full rank); ``glob``
      holds the shared rank-r_max truncation factors per spec.
    """
    if method not in ENGINE_METHODS:
        raise ValueError(f"unknown engine method {method!r} "
                         f"(expected one of {ENGINE_METHODS})")
    if method == "fedex_svd" and svd_rank < 1:
        raise ValueError(f"fedex_svd close needs svd_rank ≥ 1, got {svd_rank}"
                         " (svd_rank=0 means exact — use the fedex close)")
    if backend not in ("plain", "kernels"):
        raise ValueError(f"backend must be 'plain' or 'kernels', got "
                         f"{backend!r}")
    specs = list(specs)
    kernels = backend == "kernels"

    @torch.no_grad()
    def close(w0_leaves, stacks, weights, mask, *, uniform: bool):
        glob: Params = {}
        div_stacks = stacks
        if method == "fedex":
            if uniform:
                new_w0, glob = _uniform_close(specs, scale, w0_leaves,
                                              stacks, c_max, in_place=kernels)
            else:
                new_w0, glob = _weighted_close(specs, scale, w0_leaves,
                                               stacks, weights,
                                               kernels=kernels)
        elif method == "fedex_svd":
            new_w0, glob = _svd_close(specs, scale, svd_rank, w0_leaves,
                                      stacks, weights, kernels=kernels)
        elif method == "reinit":
            new_w0 = _reinit_close(specs, scale, w0_leaves, stacks, weights,
                                   c_max, uniform, kernels=kernels)
        elif method == "keep_local":
            new_w0 = _keep_local_close(specs, scale, w0_leaves, stacks,
                                       weights, c_max, uniform,
                                       kernels=kernels)
        else:  # hetero
            new_w0, glob, div_stacks = _hetero_close(
                specs, scale, w0_leaves, stacks, weights, mask, c_max,
                uniform, kernels=kernels)
        if uniform:
            u = torch.full((c_max,), 1.0 / c_max, dtype=torch.float32,
                           device=weights.device)
        elif method == "hetero":
            # a lane counts iff it delivered weight AND a non-empty rank
            live = ((mask > 0) & (weights > 0)).float()
            u = live / torch.clamp(live.sum(), min=1.0)
        else:
            u = mask / torch.clamp(mask.sum(), min=1.0)
        parts = [_dev_fro_scaled(div_stacks[s.key + "/a"],
                                 div_stacks[s.key + "/b"], u).reshape(-1)
                 for s in specs]
        return new_w0, glob, torch.cat(parts).mean()

    return close


class RoundCloseEngine:
    """Owns the streaming buffers and the close for a trainer.

    ``backend``: ``"auto"`` (the kernels for CUDA tensors, their plain
    versions on the CPU), ``"plain"``, or ``"kernels"`` (the kernel close on
    any device: on CPU tensors the wrappers run the plain versions, which
    lets the CPU tests drive the kernel close's plumbing).

    ``buffers`` is the coordinator's delivery sink; :meth:`close` (fedex,
    fedex_svd, reinit), :meth:`close_keep_local` and :meth:`close_hetero`
    close the oldest open round over whatever subset arrived, with any
    weighting. The C_max padding contract: stacks are always ``(C_max, …)``,
    a round's candidates get lanes in client-id order, and zero weights mask
    the rest. ``client_ranks`` (hetero) holds every client's true adapter
    rank (index = client id); the lora template is built at the largest,
    r_max.

    ``chunk > 0`` streams rounds of more than ``chunk`` candidates in chunks
    (:class:`RoundBuffers`' chunked mode): each chunk folds at ingest into
    running float32 accumulators, Σŵa and Σŵb through ``factor_mean`` and,
    for every method but fedex_svd, Σŵ·ab through ``product_accum``, and the
    close normalises them by the total raw ingest weight and finishes in
    plain PyTorch. The full (C_max, …) stacks never exist, but the product
    accumulator has the shape of the adapted W0 leaves, so at C = 6 the
    chunked close holds more memory than the stacked one; it pays off only
    where a round's uplinks outweigh one copy of the adapted W0 leaves.
    """

    def __init__(self, params: Params, lora_template: Params, *,
                 c_max: int, scale: float, method: str = "fedex",
                 svd_rank: int = 0, backend: str = "auto", depth: int = 2,
                 client_ranks: Optional[Sequence[int]] = None,
                 chunk: int = 0, recorder=None):
        self.specs = build_factor_specs(params, lora_template)
        self.c_max = c_max
        if client_ranks is not None:
            rmax = self.specs[0].a_shape[-1]
            client_ranks = tuple(int(r) for r in client_ranks)
            if len(client_ranks) != c_max:
                raise ValueError(f"client_ranks has {len(client_ranks)} "
                                 f"entries for c_max={c_max}")
            bad = [r for r in client_ranks if not 1 <= r <= rmax]
            if bad:
                raise ValueError(
                    f"client_ranks {bad} outside [1, r_max={rmax}] — the "
                    "lora template must be built at the LARGEST client rank")
        self.client_ranks = client_ranks
        self.scale = scale
        self.method = method
        self.svd_rank = svd_rank
        device = w0_leaf(self.specs[0], params).device
        self.device = device
        self.backend = _resolve_backend(backend, device)
        self.chunk = int(chunk)
        self.rec = recorder if recorder is not None else NULL
        # the analytic peak of each in-flight close's live device bytes
        self._peak: Dict[Any, int] = {}
        # keep_local folds each lane's own base, and fedex_svd / hetero
        # stream the chunks' L / R blocks again: they retain the chunks
        self.buffers = RoundBuffers(
            lora_template, c_max, depth=depth, device=device,
            chunk=self.chunk,
            on_chunk=self._fold_chunk if self.chunk else None,
            retain_chunks=method in ("keep_local", "fedex_svd", "hetero"),
            recorder=self.rec)
        self._lora_template = lora_template
        self._close = make_close_fn(self.specs, scale=scale, c_max=c_max,
                                    method=method, svd_rank=svd_rank,
                                    backend=self.backend)

    # -- obs: the close's dispatch and its analytic peak ------------------
    def _dispatch(self, w0_leaves, stacks, w, mask, uniform: bool, round_id,
                  w0_bytes: int):
        """Run the close under the ``close.dispatch`` span, which times the
        host's launches only (the device wait is the divergence's
        resolution), and stamp the round's close fields."""
        self._note_peak(round_id, w0_bytes + self._stack_bytes(self.c_max)
                        + self._div_temp_bytes(self.c_max))
        rec = self.rec
        if not rec.enabled:
            return self._close(w0_leaves, stacks, self._device(w),
                               self._device(mask), uniform=uniform)
        t0 = time.perf_counter_ns()
        with rec.span("close.dispatch", cat="engine", round=round_id,
                      method=self.method, uniform=uniform):
            out = self._close(w0_leaves, stacks, self._device(w),
                              self._device(mask), uniform=uniform)
        self._close_obs(round_id, t0)
        return out

    def _close_obs(self, round_id, t0: int, entry=None) -> None:
        """The close's dispatch time and the ring's counts on its round
        record (``entry``: a chunked round's, with its eager folds)."""
        rec = self.rec
        if not rec.enabled:
            return
        dispatch_us = (time.perf_counter_ns() - t0) / 1e3
        rec.hist("engine.close_dispatch_us").observe(dispatch_us)
        if round_id is None:
            return
        b = self.buffers
        chunked = ({} if entry is None else
                   {"chunked": 1, "partial_folds": entry["eager_folds"]})
        rec.round_set(round_id, method=self.method, **chunked,
                      close_dispatch_us=round(dispatch_us, 1),
                      ring_occupancy=len(b.open_rounds),
                      ring_evictions=b.evictions, stale_drops=b.stale_drops,
                      replay_drops=b.replay_drops,
                      duplicate_drops=b.duplicate_drops)

    def _deferred(self, div: torch.Tensor, round_id) -> DeferredDivergence:
        return DeferredDivergence(
            div, round_id, recorder=self.rec if self.rec.enabled else None)

    def _note_peak(self, round_id, nbytes: int) -> None:
        if nbytes > self._peak.get(round_id, 0):
            self._peak[round_id] = nbytes
            while len(self._peak) > RING_MEMORY:  # abandoned rounds
                self._peak.pop(next(iter(self._peak)))

    def _finish_peak(self, round_id) -> None:
        peak = self._peak.pop(round_id, 0)
        if self.rec.enabled:
            self.rec.gauge("close.peak_bytes").set(peak)
            if round_id is not None:
                self.rec.round_set(round_id, peak_bytes=peak)

    def _w0_bytes(self, copies: int = 1) -> int:
        """Bytes of ``copies`` of the adapted W0 leaves, in their dtype."""
        return copies * sum(math.prod(s.w0_shape) * s.w0_dtype.itemsize
                            for s in self.specs)

    def _stack_bytes(self, lanes: int) -> int:
        """Bytes of ``lanes`` float32 lanes of every factor leaf."""
        return 4 * lanes * sum(math.prod(s.a_shape) + math.prod(s.b_shape)
                               for s in self.specs)

    def _prod_temp_bytes(self) -> int:
        """Bytes of one dense (…, m, n) float32 temp per spec."""
        return 4 * sum(math.prod(s.a_shape[:-1]) * s.b_shape[-1]
                       for s in self.specs)

    def _acc_bytes(self) -> int:
        """Bytes of a chunked round's accumulators (:meth:`_init_acc`)."""
        prod = self._prod_temp_bytes() if self.method != "fedex_svd" else 0
        return self._stack_bytes(1) + prod

    def _div_temp_bytes(self, c: int) -> int:
        """The stacked divergence's intermediates: per spec the L (…, m,
        C·r) and R (…, C·r, n) factors and two (C·r)² Grams."""
        total = 0
        for s in self.specs:
            lead = math.prod(s.a_shape[:-2])
            m, r, n = s.a_shape[-2], s.a_shape[-1], s.b_shape[-1]
            p = c * r
            total += 4 * lead * (m * p + p * n + 2 * p * p)
        return total

    def _gram_bytes(self, slots: int) -> int:
        """The two (P, P) Grams per spec, P = ``slots`` · r."""
        return sum(2 * 4 * math.prod(s.a_shape[:-2])
                   * (slots * s.a_shape[-1]) ** 2 for s in self.specs)

    def _factor_bytes(self, rank: int) -> int:
        """Bytes of rank-``rank`` factors A′ (…, m, rank), B′ (…, rank, n)."""
        return 4 * rank * sum(math.prod(s.a_shape[:-1])
                              + math.prod(s.b_shape[:-2]) * s.b_shape[-1]
                              for s in self.specs)

    def weight_vector(self, client_ids: Sequence[int],
                      weights: Optional[Sequence[float]],
                      round_id=None) -> Tuple[np.ndarray, np.ndarray, bool]:
        """(C_max,) weights + mask from the delivered ids; uniform? flag."""
        slots = [self.buffers.slot_of(cid, round_id) for cid in client_ids]
        mask = np.zeros(self.c_max, np.float32)
        mask[slots] = 1.0
        norm = agg.normalize_weights(weights, len(client_ids))
        uniform = norm is None and len(client_ids) == self.c_max
        w = np.zeros(self.c_max, np.float32)
        if norm is None:
            w[slots] = 1.0 / len(client_ids)
        else:
            for s, wi in zip(slots, norm):
                w[s] = wi
        return w, mask, uniform

    def _open_round(self, client_ids: Sequence[int], round_id):
        """The oldest open round by default; checks the deliveries."""
        if round_id is None and self.buffers.open_rounds:
            round_id = self.buffers.open_rounds[0]  # oldest — same as take()
        if not client_ids:
            raise ValueError("cannot close a round with no deliveries")
        written = self.buffers.delivered_in(round_id)
        missing = [c for c in client_ids if c not in written]
        if missing:
            raise ValueError(f"clients {missing} were never written to the "
                             "round buffers")
        return round_id

    def _device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def close(self, params: Params, client_ids: Sequence[int],
              weights: Optional[Sequence[float]] = None, *, round_id=None,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[Params, Params, DeferredDivergence]:
        """Close the round over the delivered subset (fedex, fedex_svd and
        reinit; keep_local and hetero close per-client bases through
        :meth:`close_keep_local` / :meth:`close_hetero`). Returns
        ``(global_lora, new_params, divergence)``. ``params`` is consumed:
        on the kernel path its W0 leaves are overwritten with the fold. No
        host sync happens here; the divergence is a device scalar. reinit
        needs the round's ``rng`` (a generator on the engine's device) and
        returns fresh adapters drawn from it as the new global."""
        if self.method in ("keep_local", "hetero"):
            raise ValueError(f"the {self.method} engine closes per-client "
                             f"bases — use close_{self.method}()")
        if self.method == "reinit" and rng is None:
            raise ValueError("reinit close needs the round's rng")
        round_id = self._open_round(client_ids, round_id)
        if self.buffers.is_chunked(round_id):
            return self._close_chunked(params, client_ids, weights, round_id,
                                       rng)
        w, mask, uniform = self.weight_vector(client_ids, weights, round_id)
        w0_leaves = collect_w0_leaves(self.specs, params)
        stacks = self.buffers.take(round_id)
        new_w0, glob, div = self._dispatch(w0_leaves, stacks, w, mask,
                                           uniform, round_id,
                                           self._w0_bytes())
        self._finish_peak(round_id)
        new_params = fold_back_w0(self.specs, params, new_w0)
        if self.method == "reinit":
            global_lora = agg.reinit_adapters(self._lora_template, rng)
        else:
            global_lora = self._glob_tree(glob)
        return global_lora, new_params, self._deferred(div, round_id)

    def _glob_tree(self, glob) -> Params:
        flat = {}
        for s in self.specs:
            flat[s.key + "/a"] = glob[s.key]["a"]
            flat[s.key + "/b"] = glob[s.key]["b"]
        return unflatten_from_paths(flat)

    def _lane_bases(self, client_params, client_ids, lanes):
        """key → each lane's W0 leaf: the delivered clients' own bases, None
        on the other lanes (not produced)."""
        delivered = set(client_ids)
        lane_to_cid = {lane: cid for cid, lane in lanes.items()
                       if cid in delivered}
        return {s.key: [None if lane not in lane_to_cid else
                        w0_leaf(s, client_params[lane_to_cid[lane]])
                        for lane in range(self.c_max)]
                for s in self.specs}

    def close_keep_local(self, client_params: Sequence[Params],
                         client_ids: Sequence[int],
                         weights: Optional[Sequence[float]] = None, *,
                         round_id=None
                         ) -> Tuple[Dict[int, Params], DeferredDivergence]:
        """Close a keep_local round: every DELIVERED client's own base gets
        its residual Σ_j w_j·a_j b_j − a_i b_i folded in, one
        ``perclient_fold`` per adapted leaf over all lanes. ``client_params``
        is the trainer's per-client params list (indexed by client id); the
        delivered clients' bases are consumed (folded in place on the kernel
        path), so no two clients may share a W0 leaf. Returns
        ``({client_id: new_params}, divergence)`` for the delivered subset.
        """
        if self.method != "keep_local":
            raise ValueError(f"engine method is {self.method!r}, "
                             "not keep_local")
        round_id = self._open_round(client_ids, round_id)
        if self.buffers.is_chunked(round_id):
            return self._close_lanes_chunked(client_params, client_ids,
                                             weights, round_id)
        w, mask, uniform = self.weight_vector(client_ids, weights, round_id)
        lanes = self.buffers.lanes(round_id)
        w0_lanes = self._lane_bases(client_params, client_ids, lanes)
        stacks = self.buffers.take(round_id)
        new_lanes, _, div = self._dispatch(w0_lanes, stacks, w, mask,
                                           uniform, round_id,
                                           self._w0_bytes(self.c_max))
        self._finish_peak(round_id)
        out = {cid: self._writeback_lane(client_params, cid, new_lanes,
                                         lanes[cid]) for cid in client_ids}
        return out, self._deferred(div, round_id)

    def close_hetero(self, client_params: Sequence[Params],
                     client_ids: Sequence[int],
                     weights: Optional[Sequence[float]] = None, *,
                     round_id=None
                     ) -> Tuple[Dict[int, Params], Dict[int, Params], Params,
                                DeferredDivergence]:
        """Close a rank-heterogeneous round: ONE shared rank-r_max
        Eckart–Young truncation of the weighted factored mean (from
        (C·r_max)² Grams), then every DELIVERED client's own base absorbs
        ΔW_i = Δ̄ − a'_i b'_i, with (a'_i, b'_i) the leading rank-r_i slice
        of the shared factors, so W0_i + ΔW_i + a'_i b'_i = W0_i + Δ̄.

        Ranks come from ``client_ranks`` (template r_max when unset); a rank
        an uplink declared at ``buffers.write`` must agree with it. Bases as
        :meth:`close_keep_local`. Returns ``({cid: new_params}, {cid: rank-r_i
        lora}, global_lora, divergence)``; the global is the shared r_max
        truncation."""
        if self.method != "hetero":
            raise ValueError(f"engine method is {self.method!r}, "
                             "not hetero")
        round_id = self._open_round(client_ids, round_id)
        w, _, uniform = self.weight_vector(client_ids, weights, round_id)
        lanes = self.buffers.lanes(round_id)
        ranks = self._rank_vector(client_ids, lanes)
        declared = self.buffers.ranks_in(round_id)
        for cid in client_ids:
            lane = lanes[cid]
            if declared[lane] >= 0 and declared[lane] != ranks[lane]:
                raise ValueError(
                    f"client {cid} uplinked rank {declared[lane]}, "
                    f"registered rank {ranks[lane]}")
        if self.buffers.is_chunked(round_id):
            return self._close_lanes_chunked(client_params, client_ids,
                                             weights, round_id)
        rmax = self.specs[0].a_shape[-1]
        # the operator-composition branch also needs every lane at r_max
        uniform = uniform and bool(np.all(ranks == rmax))
        w0_lanes = self._lane_bases(client_params, client_ids, lanes)
        stacks = self.buffers.take(round_id)
        new_lanes, glob, div = self._dispatch(w0_lanes, stacks, w, ranks,
                                              uniform, round_id,
                                              self._w0_bytes(self.c_max))
        self._finish_peak(round_id)
        out = {cid: self._writeback_lane(client_params, cid, new_lanes,
                                         lanes[cid]) for cid in client_ids}
        global_lora = self._glob_tree(glob)
        client_loras = self._hetero_loras(glob, client_ids, ranks, lanes)
        return out, client_loras, global_lora, self._deferred(div, round_id)

    # -- hetero helpers --------------------------------------------------
    def _client_rank(self, cid: int) -> int:
        """Client ``cid``'s true adapter rank (template r_max when no
        per-client ranks were registered)."""
        if self.client_ranks is None:
            return self.specs[0].a_shape[-1]
        return int(self.client_ranks[cid])

    def _rank_vector(self, client_ids, lanes) -> np.ndarray:
        """(C_max,) int32 slot-indexed rank vector for the delivered set: 0
        on non-delivered lanes (fully masked), the true rank on delivered
        ones. Rides in the close's ``mask`` slot."""
        ranks = np.zeros(self.c_max, np.int32)
        for cid in client_ids:
            ranks[lanes[cid]] = self._client_rank(cid)
        return ranks

    def _writeback_lane(self, client_params, cid, new_lanes, lane) -> Params:
        """Client ``cid``'s params with lane ``lane`` of the per-lane W0
        results folded back in (spine copy)."""
        return fold_back_w0(self.specs, client_params[cid],
                            {s.key: new_lanes[s.key][lane]
                             for s in self.specs})

    def _hetero_loras(self, glob, client_ids, ranks, lanes
                      ) -> Dict[int, Params]:
        """Per-client rank-r_i adapters: the LEADING slices of the shared
        r_max truncation factors."""
        out: Dict[int, Params] = {}
        for cid in client_ids:
            r_i = int(ranks[lanes[cid]])
            flat = {}
            for s in self.specs:
                flat[s.key + "/a"] = glob[s.key]["a"][..., :, :r_i]
                flat[s.key + "/b"] = glob[s.key]["b"][..., :r_i, :]
            out[cid] = unflatten_from_paths(flat)
        return out

    # -- chunked mode ------------------------------------------------------
    def _init_acc(self) -> Dict[str, torch.Tensor]:
        """Fresh float32 accumulators: the weighted factor sums Σŵa / Σŵb for
        every method, plus the product accumulator Σŵ·ab, shaped like the
        adapted W0 leaf, for the methods whose close needs the dense ideal
        update (fedex_svd works from Gram blocks of the retained chunks)."""
        acc: Dict[str, torch.Tensor] = {}
        for s in self.specs:
            acc["ga/" + s.key] = torch.zeros(s.a_shape, device=self.device)
            acc["gb/" + s.key] = torch.zeros(s.b_shape, device=self.device)
            if self.method != "fedex_svd":
                acc["prod/" + s.key] = torch.zeros(
                    s.a_shape[:-1] + s.b_shape[-1:], device=self.device)
        return acc

    @torch.no_grad()
    def _fold_chunk(self, acc, stacks, w: np.ndarray, round_id, k: int):
        """The ring's ``on_chunk`` callback: acc += Σ_lanes ŵ·(a, b, a b)
        over one chunk, ŵ its raw ingest weights. On the kernel backend the
        factor sums go through ``factor_mean`` and the product through
        ``product_accum``, in place; a zero-weight lane (an unwritten row)
        is never read by either. A hetero chunk is rank-masked first (by
        selection) and retained masked."""
        if acc is None:
            acc = self._init_acc()
        wd = torch.from_numpy(w).to(self.device)
        if self.method == "hetero":
            ranks = torch.from_numpy(
                self.buffers.chunk_ranks(round_id, k)).to(self.device)
            for s in self.specs:
                pa, pb = s.key + "/a", s.key + "/b"
                stacks[pa], stacks[pb] = _mask_factor_stacks(stacks[pa],
                                                             stacks[pb], ranks)
        kernels = self.backend == "kernels"
        if kernels:  # one grouped launch: acc ← acc + Σ ŵ x, in place
            factor_mean_group(
                [stacks[s.key + f] for s in self.specs for f in ("/a", "/b")],
                wd, out=[acc[g + s.key] for s in self.specs
                         for g in ("ga/", "gb/")], accumulate=True)
        for s in self.specs:
            a, b = stacks[s.key + "/a"], stacks[s.key + "/b"]
            if not kernels:
                acc["ga/" + s.key].add_(factor_mean_plain(a, wd))
                acc["gb/" + s.key].add_(factor_mean_plain(b, wd))
            prod = "prod/" + s.key
            if prod not in acc:
                continue
            if kernels:
                product_accum(acc[prod], a, b, wd, 1.0)
            else:
                acc[prod] = product_accum_plain(acc[prod], a, b, wd, 1.0)
        self._note_peak(round_id, self._stack_bytes(self.buffers.chunk)
                        + self._acc_bytes() + 4 * self.buffers.chunk)
        return acc

    @staticmethod
    def _check_ingest_weights(entry, w: np.ndarray, round_id) -> float:
        """A chunked round weights at INGEST: check that the streamed raw
        weights normalise to the close's weight vector and return their sum.
        A mismatch means the chunks folded under another weighting (or
        another delivered set) than the close asks for; the accumulators are
        already wrong, so this raises."""
        raw = entry["w"].astype(np.float64)
        wsum = float(raw.sum())
        if wsum <= 0.0:
            raise ValueError("chunked close: total ingest weight is 0")
        for cid, slot in entry["written"].items():
            want = float(w[slot]) if slot < len(w) else 0.0
            got = raw[slot] / wsum
            if not np.isclose(got, want, rtol=1e-4, atol=1e-6):
                raise ValueError(
                    f"chunked close of round {round_id!r}: client {cid}'s "
                    f"ingest weight normalises to {got:.6g} but the close "
                    f"was given {want:.6g} — stream and close must use the "
                    "same weighting (and the same delivered set)")
        return wsum

    def _take_chunked(self, client_ids, weights, round_id):
        """Flush and pop a chunked round; returns (round id, entry, the
        close's (C_max,) weight vector, 1/Σ raw ingest weights in f32)."""
        w, _, _ = self.weight_vector(client_ids, weights, round_id)
        rid, entry = self.buffers.take_chunked(round_id)
        wsum = self._check_ingest_weights(entry, w, rid)
        return rid, entry, w, float(np.float32(1.0) / np.float32(wsum))

    def _slot_weights(self, entry, w: np.ndarray) -> torch.Tensor:
        """The close's normalised weights over every slot of the round's
        chunks (a round's chunks may pad past C_max)."""
        wn = np.zeros(entry["num_chunks"] * self.buffers.chunk, np.float32)
        n = min(len(w), len(wn))
        wn[:n] = w[:n]
        return torch.from_numpy(wn).to(self.device)

    def _chunk_truncation(self, entry, key: str, wn: torch.Tensor,
                          bbar: torch.Tensor, rank: int):
        """The rank-``rank`` Eckart–Young truncation of L @ R from the
        retained chunks of one spec: chunk-pair Gram blocks G_L[i, j] =
        L_iᵀ L_j and G_R[i, j] = R_i R_jᵀ (j ≤ i, the rest mirrored) tile the
        stacked (C·r)² Grams; the eigh/eigh/SVD core of
        :func:`factored_truncated_residual` runs on them, and every chunk
        streams through the projections in slot order. Returns (A′₀, the
        top singular values, B′₀, G_L, G_R) with the stacked close's A′ =
        A′₀·diag(s); the dense (m, n) matrix never exists. ``bbar`` centres
        R (zeros for the hetero close's uncentred product)."""
        chunk, nk = self.buffers.chunk, entry["num_chunks"]
        ls, rs = [], []
        for k in range(nk):
            stacks, wk = entry["retained"][k], wn[k * chunk:(k + 1) * chunk]
            ls.append(_l_block(stacks[key + "/a"], wk))
            rs.append(_r_block(stacks[key + "/b"], bbar, wk))
        gl_blocks, gr_blocks = {}, {}
        for i in range(nk):
            for j in range(i + 1):
                gl_blocks[i, j] = torch.einsum("...mi,...mj->...ij", ls[i],
                                               ls[j])
                gr_blocks[i, j] = torch.einsum("...in,...jn->...ij", rs[i],
                                               rs[j])

        def assemble(blocks):
            return torch.cat([torch.cat(
                [blocks[i, j] if j <= i else blocks[j, i].transpose(-1, -2)
                 for j in range(nk)], dim=-1) for i in range(nk)], dim=-2)

        gl, gr = assemble(gl_blocks), assemble(gr_blocks)
        left, u, sv, vt, right = _core_of_grams(gl, gr)
        projl = left @ u[..., :, :rank]
        projr = vt[..., :rank, :] @ right
        cr = ls[0].shape[-1]
        ap = torch.zeros(ls[0].shape[:-1] + (projl.shape[-1],),
                         device=self.device)
        bp = torch.zeros(projr.shape[:-1] + rs[0].shape[-1:],
                         device=self.device)
        for k in range(nk):
            ap = ap + ls[k] @ projl[..., k * cr:(k + 1) * cr, :]
            bp = bp + projr[..., :, k * cr:(k + 1) * cr] @ rs[k]
        return ap, sv[..., :rank], bp, gl, gr

    @torch.no_grad()
    def _close_chunked(self, params: Params, client_ids, weights, round_id,
                       rng) -> Tuple[Params, Params, DeferredDivergence]:
        """Chunked fedex / fedex_svd / reinit close: flush the trailing
        chunks in slot order, normalise the accumulators by the total raw
        ingest weight W, and fold. fedex / reinit: ideal = Σŵ·ab / W and
        residual = ideal − ā b̄ (one dense temp per leaf), W0 + s·residual
        (fedex) or W0 + s·ideal (reinit); the divergence ‖residual‖_F/√(mn)
        under the INGEST weights. fedex_svd: the truncation from chunk-pair
        Gram blocks (:meth:`_chunk_truncation`), its divergence off the
        Grams. The kernel backend folds into W0's own storage."""
        rid, entry, w, winv = self._take_chunked(client_ids, weights,
                                                 round_id)
        t0 = time.perf_counter_ns()
        with self.rec.span("close.dispatch", cat="engine", round=rid,
                           method=self.method, uniform=False, chunked=True):
            new_w0, glob, parts = self._finish_chunked(params, entry, w,
                                                       winv, rid)
        self._close_obs(rid, t0, entry)
        self._finish_peak(rid)
        new_params = fold_back_w0(self.specs, params, new_w0)
        if self.method == "reinit":
            global_lora = agg.reinit_adapters(self._lora_template, rng)
        else:
            global_lora = self._glob_tree(glob)
        return global_lora, new_params, self._deferred(
            torch.cat(parts).mean(), rid)

    def _finish_chunked(self, params, entry, w, winv, rid):
        """The body of :meth:`_close_chunked`: (new W0 leaves, glob, the
        divergence's parts)."""
        acc, in_place = entry["acc"], self.backend == "kernels"
        w0_leaves = collect_w0_leaves(self.specs, params)
        wn = self._slot_weights(entry, w)
        acc_bytes = self._acc_bytes()
        if self.method == "fedex_svd":
            gram = self._gram_bytes(entry["num_chunks"] * self.buffers.chunk)
            self._note_peak(rid, 2 * gram + acc_bytes)
            self._note_peak(rid, gram + self._factor_bytes(self.svd_rank)
                            + self._w0_bytes() + acc_bytes)
        else:
            self._note_peak(rid, self._w0_bytes() + acc_bytes
                            + self._prod_temp_bytes())
        new_w0, glob, parts = {}, {}, []
        for s in self.specs:
            w0 = w0_leaves[s.key]
            ga = acc["ga/" + s.key].mul_(winv)
            gb = acc["gb/" + s.key].mul_(winv)
            if self.method == "fedex_svd":
                ap, sv, bp, gl, gr = self._chunk_truncation(
                    entry, s.key, wn, gb, self.svd_rank)
                new_w0[s.key] = _fold_update(
                    w0, torch.matmul(ap * sv[..., None, :], bp), self.scale,
                    s.w0_dtype, in_place)
                fro_sq = torch.clamp(torch.einsum("...ij,...ij->...", gl, gr),
                                     min=0.0)
                mn = s.a_shape[-2] * s.b_shape[-1]
                parts.append((torch.sqrt(fro_sq) / math.sqrt(mn)).reshape(-1))
            else:
                ideal = acc["prod/" + s.key].mul_(winv)
                res, part = _residual(ideal, ga, gb)
                parts.append(part)
                upd = ideal if self.method == "reinit" else res
                new_w0[s.key] = _fold_update(w0, upd, self.scale,
                                             s.w0_dtype, in_place)
                del res, upd
            glob[s.key] = {"a": ga, "b": gb}
        return new_w0, glob, parts

    @torch.no_grad()
    def _close_lanes_chunked(self, client_params, client_ids, weights,
                             round_id):
        """Chunked keep_local / hetero close: the ideal update Σŵ·ab / W and
        the divergence from the accumulators, then every delivered lane, in
        slot order, folds W0_c + s·(ideal − own_c) into its OWN base, one
        dense temp at a time: own_c = a_c b_c from the retained chunk
        (keep_local), or the leading rank-r_c slice of the shared
        r_max truncation (hetero, from uncentred chunk-pair Grams). Returns
        what :meth:`close_keep_local` / :meth:`close_hetero` return."""
        hetero = self.method == "hetero"
        lanes = self.buffers.lanes(round_id)
        ranks = self._rank_vector(client_ids, lanes)
        rid, entry, w, winv = self._take_chunked(client_ids, weights,
                                                 round_id)
        t0 = time.perf_counter_ns()
        with self.rec.span("close.dispatch", cat="engine", round=rid,
                           method=self.method, uniform=False, chunked=True):
            out, glob, parts = self._finish_lanes_chunked(
                client_params, client_ids, lanes, ranks, entry, w, winv, rid)
        self._close_obs(rid, t0, entry)
        self._finish_peak(rid)
        div = self._deferred(torch.cat(parts).mean(), rid)
        if not hetero:
            return out, div
        return (out, self._hetero_loras(glob, client_ids, ranks, lanes),
                self._glob_tree(glob), div)

    def _finish_lanes_chunked(self, client_params, client_ids, lanes, ranks,
                              entry, w, winv, rid):
        """The body of :meth:`_close_lanes_chunked`: ({cid: new params},
        glob, the divergence's parts)."""
        hetero = self.method == "hetero"
        lane_to_cid = {lane: cid for cid, lane in lanes.items()}
        delivered = set(client_ids)
        acc, in_place = entry["acc"], self.backend == "kernels"
        wn = self._slot_weights(entry, w)
        chunk, acc_bytes = self.buffers.chunk, self._acc_bytes()
        # the reference's per-chunk peak: one chunk of per-lane W0s beside
        # the dense ideal, and the retained chunk (keep_local) or the
        # shared truncation's factors (hetero)
        lane_peak = (self._prod_temp_bytes() + self._w0_bytes(chunk)
                     + acc_bytes)
        if hetero:
            self._note_peak(rid, 2 * self._gram_bytes(
                entry["num_chunks"] * chunk) + acc_bytes)
            lane_peak += self._factor_bytes(self.specs[0].a_shape[-1])
        else:
            lane_peak += self._stack_bytes(chunk)
        self._note_peak(rid, lane_peak)
        ideal, glob, parts = {}, {}, []
        for s in self.specs:
            ga = acc["ga/" + s.key].mul_(winv)
            gb = acc["gb/" + s.key].mul_(winv)
            ideal[s.key] = acc["prod/" + s.key].mul_(winv)
            parts.append(_residual(ideal[s.key], ga, gb)[1])
            if hetero:
                ap, sv, bp, _, _ = self._chunk_truncation(
                    entry, s.key, wn, torch.zeros_like(gb), s.a_shape[-1])
                sq = torch.sqrt(torch.clamp(sv, min=0.0))
                glob[s.key] = {"a": ap * sq[..., None, :],
                               "b": sq[..., :, None] * bp}
        new_lanes = {s.key: [None] * self.c_max for s in self.specs}
        for lane in range(entry["num_chunks"] * chunk):
            cid = lane_to_cid.get(lane)
            if cid is None or cid not in delivered:
                continue
            stacks = entry["retained"][lane // chunk]
            for s in self.specs:
                if hetero:
                    k, g = int(ranks[lane]), glob[s.key]
                    own = torch.matmul(g["a"][..., :k], g["b"][..., :k, :])
                else:
                    row = lane % chunk
                    own = torch.matmul(stacks[s.key + "/a"][row],
                                       stacks[s.key + "/b"][row])
                torch.sub(ideal[s.key], own, out=own)
                w0 = w0_leaf(s, client_params[cid])
                new_lanes[s.key][lane] = _fold_update(w0, own, self.scale,
                                                      s.w0_dtype, in_place)
                del own
        out = {cid: self._writeback_lane(client_params, cid, new_lanes,
                                         lanes[cid]) for cid in client_ids}
        return out, glob, parts
