"""Seeded, composable fault injection for the uplink path.

The port's copy of ``repro/fedsrv/faults.py`` (no recorder). A
:class:`FaultPlan` is a list of :class:`FaultSpec` fault models, each a
*kind* of misbehaviour, a probability and the (round, client) scope it
applies to. :class:`FaultInjector` evaluates the plan deterministically:
every (spec, round, client) coin comes from its own numpy
``purpose_rng(seed, round, client, FAULT_STREAM, spec_index)`` stream and
every corruption index from ``…, spec_index, 1)``, drawn in the reference's
order, so a plan corrupts the same byte of the same leaf as the JAX
package, and a client drawn as dropped cannot shift another's faults.

Fault kinds (the coordinator applies them between ``AdapterCodec.encode``
and delivery):

==============  ===========================================================
``nan``         poison one element of the payload's first leaf with NaN
                (int8 payloads: the dequant scale); quarantined
``inf``         the same with +inf
``bitflip``     flip one random bit of one leaf's raw bytes
``truncate``    chop trailing elements off the first leaf, keeping its
                declared shape: the decode refuses the length (``bytes``)
``scale``       byzantine client: every leaf × ``factor``; quarantined
                only under the codec's norm ceiling
``replay``      rewind the payload's round_id by ``offset``: the ring (or,
                without one, the coordinator) drops it
``duplicate``   deliver the (client, round) payload twice: the ring drops
                the second copy
``crash``       the client dies mid-uplink: nothing arrives
``decode_error``  the first ``count`` decode attempts raise
                ``TransientTransportError``; the coordinator retries
==============  ===========================================================

Payloads hold device tensors, and the ``none`` codec's payload holds the
client's own float32 leaves: every primitive writes into a copy, never into
the payload it was given.

Plan DSL (``FedConfig.faults`` / ``--faults``): specs are ``;``-separated,
each ``kind@prob(key=value,...)`` with ``+``-separated id lists, e.g.::

    nan@1.0(clients=2,rounds=0);scale@0.5(clients=1+3,factor=1e3);crash@0.1

Omitted ``clients=``/``rounds=`` mean "all"; ``@prob`` defaults to 1.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.fedsrv.registry import FAULT_STREAM, purpose_rng
from repro_torch.fedsrv.transport import Payload, TransientTransportError
from repro_torch.obs import NULL

FAULT_KINDS = ("nan", "inf", "bitflip", "truncate", "scale", "replay",
               "duplicate", "crash", "decode_error")
# kinds that mutate the payload itself (the others are flags the
# coordinator acts on)
PAYLOAD_KINDS = ("nan", "inf", "bitflip", "truncate", "scale", "replay")
# kinds the defended decode must catch whenever validation is on (scale
# joins them only under a norm ceiling)
DETECTABLE_KINDS = ("nan", "inf", "truncate")
# the adapter-value kinds that apply to co-scheduled lanes, which have no
# wire (corrupt_lane)
MESH_KINDS = ("nan", "inf", "scale")
_VALUE = {"nan": float("nan"), "inf": float("inf")}


@dataclass(frozen=True)
class FaultSpec:
    """One fault model: a kind, a probability, and its (round, client)
    scope."""

    kind: str
    prob: float = 1.0
    clients: Optional[Tuple[int, ...]] = None   # None → every client
    rounds: Optional[Tuple[int, ...]] = None    # None → every round
    factor: float = 1e3    # scale: byzantine multiplier
    count: int = 1         # decode_error: failures before success
    offset: int = 1        # replay: rounds to rewind the round_id by

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], got {self.prob}")
        if self.count < 1:
            raise ValueError(f"fault count must be ≥ 1, got {self.count}")
        if self.offset < 1:
            raise ValueError(f"replay offset must be ≥ 1, got {self.offset}")

    def in_scope(self, round_id: int, client_id: int) -> bool:
        if self.rounds is not None and round_id not in self.rounds:
            return False
        if self.clients is not None and client_id not in self.clients:
            return False
        return True

    def __str__(self) -> str:
        args = []
        if self.clients is not None:
            args.append("clients=" + "+".join(map(str, self.clients)))
        if self.rounds is not None:
            args.append("rounds=" + "+".join(map(str, self.rounds)))
        if self.kind == "scale":
            args.append(f"factor={self.factor:g}")
        if self.kind == "decode_error" and self.count != 1:
            args.append(f"count={self.count}")
        if self.kind == "replay" and self.offset != 1:
            args.append(f"offset={self.offset}")
        out = f"{self.kind}@{self.prob:g}"
        return out + (f"({','.join(args)})" if args else "")


def _parse_ids(text: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in text.split("+") if x != "")


def _parse_spec(text: str) -> FaultSpec:
    text = text.strip()
    args: Dict[str, Any] = {}
    if "(" in text:
        if not text.endswith(")"):
            raise ValueError(f"unbalanced parens in fault spec {text!r}")
        text, arg_text = text[:-1].split("(", 1)
        for item in arg_text.split(","):
            if not item.strip():
                continue
            if "=" not in item:
                raise ValueError(f"fault spec arg {item!r} is not key=value")
            k, v = (s.strip() for s in item.split("=", 1))
            if k in ("clients", "rounds"):
                args[k] = _parse_ids(v)
            elif k == "factor":
                args["factor"] = float(v)
            elif k in ("count", "offset"):
                args[k] = int(v)
            else:
                raise ValueError(f"unknown fault spec arg {k!r} "
                                 "(clients|rounds|factor|count|offset)")
    kind, _, prob = text.partition("@")
    return FaultSpec(kind=kind.strip(),
                     prob=float(prob) if prob else 1.0, **args)


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded collection of fault models."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``;``-separated plan DSL (see the module docstring)."""
        specs = tuple(_parse_spec(s) for s in text.split(";") if s.strip())
        return cls(specs=specs, seed=seed)

    def __str__(self) -> str:
        return ";".join(str(s) for s in self.specs)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` against the uplink stream.

    The coordinator calls :meth:`corrupt` on every encoded uplink and
    :meth:`check_transient` on every decode attempt. Every decision is a
    function of ``(plan.seed, round, client, spec index)`` alone.
    ``injected`` logs every fault applied, as ``{"round", "client",
    "kind"}`` (a replay under its original round); a live ``recorder``
    counts them as ``fault.injected[kind]``.
    """

    def __init__(self, plan: FaultPlan, recorder=None):
        self.plan = plan
        self.rec = recorder if recorder is not None else NULL
        self.injected: List[Dict[str, Any]] = []
        # (round, client) → transient decode failures still owed
        self._transient: Dict[Tuple[int, int], int] = {}

    def draws(self, round_id: int, client_id: int
              ) -> List[Tuple[int, FaultSpec]]:
        """The (index, spec) pairs active for one (round, client) uplink.
        Pure: calling it twice, or never, shifts no other draw; a spec of
        prob ≥ 1 draws no coin."""
        out = []
        for i, spec in enumerate(self.plan.specs):
            if not spec.in_scope(round_id, client_id):
                continue
            if spec.prob >= 1.0:
                out.append((i, spec))
            elif spec.prob > 0.0:
                rng = purpose_rng(self.plan.seed, round_id, client_id,
                                  FAULT_STREAM, i)
                if rng.random() < spec.prob:
                    out.append((i, spec))
        return out

    def corrupt(self, payload: Payload) -> Tuple[Payload, List[FaultSpec]]:
        """Apply the plan to one uplink payload. Returns ``(payload',
        applied)``: the payload kinds act on a copy, the flag kinds (crash,
        duplicate, decode_error) are returned for the coordinator."""
        applied: List[FaultSpec] = []
        for i, spec in self.draws(payload.round_id, payload.client_id):
            # a stream of its own for the corruption's indices, so the
            # activation coin stays untouched
            rng = purpose_rng(self.plan.seed, payload.round_id,
                              payload.client_id, FAULT_STREAM, i, 1)
            if spec.kind in ("nan", "inf"):
                payload = _poison(payload, _VALUE[spec.kind], rng)
            elif spec.kind == "bitflip":
                payload = _bitflip(payload, rng)
            elif spec.kind == "truncate":
                payload = _truncate(payload, rng)
            elif spec.kind == "scale":
                payload = _scale(payload, spec.factor)
            elif spec.kind == "replay":
                payload = replace(payload,
                                  round_id=payload.round_id - spec.offset)
            elif spec.kind == "decode_error":
                key = (payload.round_id, payload.client_id)
                self._transient[key] = spec.count
            applied.append(spec)
            self.injected.append({
                "round": payload.round_id + (spec.offset if spec.kind
                                             == "replay" else 0),
                "client": payload.client_id, "kind": spec.kind})
            self._note(self.injected[-1])
        return payload, applied

    def _note(self, fault: Dict[str, Any]) -> None:
        if self.rec.enabled:
            self.rec.counter(f"fault.injected[{fault['kind']}]").inc()
            self.rec.event("fault.inject", cat="faults", **fault)

    def corrupt_lane(self, round_id: int, client_id: int,
                     leaves: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], List[FaultSpec]]:
        """Value faults on one co-scheduled lane's leaves (path → tensor):
        the same coins as :meth:`corrupt`, only :data:`MESH_KINDS` apply.
        Returns new tensors for the corrupted paths; the inputs are never
        written."""
        applied: List[FaultSpec] = []
        for i, spec in self.draws(round_id, client_id):
            if spec.kind not in MESH_KINDS:
                continue
            rng = purpose_rng(self.plan.seed, round_id, client_id,
                              FAULT_STREAM, i, 1)
            if spec.kind == "scale":
                factor = torch.tensor(spec.factor, dtype=torch.float32)
                leaves = {p: x * factor for p, x in leaves.items()}
            else:
                path = sorted(leaves)[0]
                leaves = {**leaves, path: _poisoned(leaves[path],
                                                    _VALUE[spec.kind], rng)}
            applied.append(spec)
            self.injected.append({"round": round_id, "client": client_id,
                                  "kind": spec.kind})
            self._note(self.injected[-1])
        return leaves, applied

    def check_transient(self, round_id: int, client_id: int) -> None:
        """Raise ``TransientTransportError`` while this (round, client)
        still owes transient decode failures (one consumed a call)."""
        key = (round_id, client_id)
        remaining = self._transient.get(key, 0)
        if remaining > 0:
            self._transient[key] = remaining - 1
            if self._transient[key] == 0:
                del self._transient[key]
            raise TransientTransportError(
                f"transient decode failure ({remaining} remaining)",
                round_id=round_id, client_id=client_id, reason="transient")


# --------------------------------------------------------------------------
# payload corruption primitives (copy-on-write)
# --------------------------------------------------------------------------

def _copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy: its flat view is the array's C-order bytes."""
    return x.clone(memory_format=torch.contiguous_format)


def _poisoned(x: torch.Tensor, value: float,
              rng: np.random.Generator) -> torch.Tensor:
    """A copy of ``x`` with ``value`` written at one drawn element."""
    out = _copy(x)
    if out.numel():
        out.view(-1)[int(rng.integers(out.numel()))] = value
    return out


def _with(payload: Payload, path: str, **fields) -> Payload:
    enc = replace(payload.tensors[path], **fields)
    return replace(payload, tensors={**payload.tensors, path: enc})


def _poison(payload: Payload, value: float,
            rng: np.random.Generator) -> Payload:
    """Write ``value`` into one element of the first leaf (an int8 payload
    carries no float storage: its dequant scale instead, with no draw)."""
    path = sorted(payload.tensors)[0]
    enc = payload.tensors[path]
    if enc.data.dtype == torch.int8:
        return _with(payload, path, scale=torch.full_like(enc.scale, value))
    return _with(payload, path, data=_poisoned(enc.data, value, rng))


def _scale(payload: Payload, factor: float) -> Payload:
    """Byzantine client: every leaf × ``factor`` (int8: its float64 scale;
    the encoder never emits a zero scale, so the reference's ``or 1.0``
    never applies). A float leaf multiplies by the factor rounded to its
    own dtype, as numpy's ``data.dtype.type(factor)``."""
    out = {}
    for path, enc in payload.tensors.items():
        if enc.data.dtype == torch.int8:
            out[path] = replace(enc, scale=enc.scale * factor)
        else:
            out[path] = replace(enc, data=enc.data * torch.tensor(
                factor, dtype=enc.data.dtype))
    return replace(payload, tensors=out)


def _bitflip(payload: Payload, rng: np.random.Generator) -> Payload:
    """Flip one drawn bit of one drawn byte of one drawn leaf (both sides
    little-endian, so the byte is the reference's ``tobytes()`` one)."""
    paths = sorted(payload.tensors)
    path = paths[int(rng.integers(len(paths)))]
    data = _copy(payload.tensors[path].data)
    raw = data.view(-1).view(torch.uint8)
    if raw.numel():
        byte = int(rng.integers(raw.numel()))
        raw.narrow(0, byte, 1).bitwise_xor_(1 << int(rng.integers(8)))
    return _with(payload, path, data=data)


def _truncate(payload: Payload, rng: np.random.Generator) -> Payload:
    """Chop trailing elements off the first leaf's wire data, keeping its
    declared shape: the decode must refuse the length mismatch."""
    path = sorted(payload.tensors)[0]
    enc = payload.tensors[path]
    flat = enc.data.reshape(-1)
    n = flat.numel()
    if n < 2:
        return payload
    drop = 1 + int(rng.integers(max(1, n // 4)))
    return _with(payload, path, data=flat[:n - drop].clone(),
                 shape=enc.declared_shape)
