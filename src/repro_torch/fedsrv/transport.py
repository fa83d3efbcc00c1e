"""Adapter transport: uplink quantization, validation and the bytes ledger.

The port's copy of ``repro/fedsrv/transport.py``; the HTTP framing is
:mod:`repro_torch.fedsrv.wire`. Every uplink crosses :class:`AdapterCodec`, so an fp16 or int8
uplink changes the numbers the server aggregates, and every payload lands in
the :class:`BytesLedger`, whose per-round parameter counts reconcile against
``repro_torch.core.comm.round_comm_params``.

The codec works on the device tensors themselves:

* ``none`` — the payload holds the client's float32 tensors (no copy); the
  ring copies them into the lane once.
* ``fp16`` — ``x.half()`` on the device (IEEE round-to-nearest-even, an
  overflow becomes ±inf); decode upcasts.
* ``int8`` — per-leaf symmetric absmax codes, each leaf stacked over its
  layers. The reference takes the scale as a Python float, ``absmax /
  127.0`` in float64 from the float32 absmax (1.0 for an all-zero leaf, and
  for a leaf whose absmax is NaN), and divides and dequantizes with it cast
  to float32. Here the same steps run on the device: the float64 division
  and the cast, then ``round(x / scale32)`` (round half to even, as
  ``np.rint``), the clip to ±127 and NaN → 0 (numpy's cast of a NaN code on
  x86), so the codes and the decoded values are the reference's bit for
  bit. The divisors are device tensors: PyTorch's CUDA kernels multiply by
  the reciprocal of a Python-number divisor.

Encoding makes no host sync. Decoding makes one per payload: the defended
check (:class:`ValidationPolicy`: wire length against the declared shape,
the registered spec, a finite check and an optional ∞-norm ceiling) stacks
every leaf's float64 sum and absmax and moves them to the host together.
A failure raises a :class:`TransportError` with the payload's (round,
client), and the coordinator quarantines the uplink: its lane stays unread.

With a live recorder the codec records the ``codec.encode`` /
``codec.decode`` spans, ``transport.{direction}_bytes`` and ``_payloads``,
and the ``uplink.ingest_bytes_per_s`` gauge (wire bytes landed in the sink
over the wall time since the first one); none of them waits for the device.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.obs import NULL
from repro_torch.util.tree import flatten_with_paths, unflatten_from_paths

CODECS = ("none", "fp16", "int8")


class TransportError(RuntimeError):
    """A payload failed decode/validation — quarantine it (round/client
    context travels with the error; ``reason`` is the short label)."""

    def __init__(self, message: str, *, round_id=None, client_id=None,
                 reason: str = "corrupt"):
        super().__init__(
            f"round={round_id} client={client_id} [{reason}]: {message}")
        self.round_id = round_id
        self.client_id = client_id
        self.reason = reason


class TransientTransportError(TransportError):
    """A decode failure worth retrying (the coordinator backs off on its
    SimClock and tries again up to its retry budget)."""


class StaleUplinkError(TransportError):
    """The payload's address is bad — an evicted, closed or unknown round,
    or a duplicate (client, round) lane — so the ring refused it. Dropped,
    not quarantined: the bytes never threatened a live lane."""


@dataclass(frozen=True)
class EncodedTensor:
    data: torch.Tensor                   # float32 / float16 / int8, on device
    scale: Optional[torch.Tensor] = None  # int8: 0-dim float64 absmax/127
    # declared logical shape; None → data.shape (a truncated wire buffer
    # keeps its declared shape, so the decode can detect the mismatch)
    shape: Optional[Tuple[int, ...]] = None

    @property
    def declared_shape(self) -> Tuple[int, ...]:
        return self.shape if self.shape is not None else tuple(self.data.shape)

    @property
    def nbytes(self) -> int:
        """Wire bytes: element size × elements, plus 4 B for an int8 scale
        (the reference's wire sends it as float32)."""
        return (self.data.element_size() * self.data.numel()
                + (4 if self.scale is not None else 0))

    @property
    def num_params(self) -> int:
        return int(self.data.numel())


@dataclass(frozen=True)
class Payload:
    """One adapter tree in flight (uplink delta or downlink global).
    ``rank`` is the declared rank of a ragged (hetero) uplink, ``None`` for
    a uniform-rank one."""

    round_id: int
    client_id: int
    direction: str              # "uplink" | "downlink"
    codec: str
    tensors: Dict[str, EncodedTensor]
    rank: Optional[int] = None

    @property
    def num_params(self) -> int:
        return sum(t.num_params for t in self.tensors.values())

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())


@dataclass(frozen=True)
class ValidationPolicy:
    """What the defended decode checks (quarantine on failure).
    ``max_norm`` is the per-leaf ∞-norm ceiling (0 disables it);
    ``check_spec`` bites once :meth:`AdapterCodec.register_spec` ran."""

    enabled: bool = True
    check_finite: bool = True
    check_spec: bool = True
    max_norm: float = 0.0


def _int8_encode(leaves: List[torch.Tensor]) -> List[EncodedTensor]:
    """int8 codes and 0-dim float64 scales of same-device leaves — the
    reference's rounding step for step (module docstring), the scales of
    all leaves in one batch: the codec is launch-bound (≈ 2.3 M entries a
    payload, a few µs of device time an operation)."""
    if not leaves:
        return []
    x = [leaf.float() for leaf in leaves]
    dev = x[0].device
    absmax = torch.stack([t.abs().amax() if t.numel()
                          else t.new_zeros(()) for t in x]).double()
    d127 = torch.full((), 127.0, dtype=torch.float64, device=dev)  # no copy
    scales = torch.where(absmax > 0, absmax / d127, 1.0)
    scales32 = scales.float()
    out = []
    for i, t in enumerate(x):
        q = torch.round(t / scales32[i])
        q.clamp_(-127.0, 127.0).nan_to_num_(nan=0.0)
        out.append(EncodedTensor(q.to(torch.int8), scales[i]))
    return out


class AdapterCodec:
    """Encode/decode adapter trees with optional uplink quantization
    (``none``: 4 B a parameter; ``fp16``: 2 B; ``int8``: 1 B plus a 4 B
    scale a leaf). Decoding is defended: see the module docstring."""

    def __init__(self, quantize: str = "none", recorder=None,
                 validation: Optional[ValidationPolicy] = None):
        if quantize not in CODECS:
            raise ValueError(f"quantize must be one of {CODECS}, got "
                             f"{quantize!r}")
        self.quantize = quantize
        # the coordinator hands its own recorder down
        self.rec = recorder if recorder is not None else NULL
        # wire bytes landed by decode_into and the time of the first (the
        # HTTP service's handler threads share them: own lock)
        self._ingest_bytes = 0
        self._ingest_t0: Optional[int] = None
        self._ingest_lock = threading.Lock()
        self.validation = (validation if validation is not None
                           else ValidationPolicy())
        # path → expected decoded leaf shape (register_spec)
        self.spec: Optional[Dict[str, Tuple[int, ...]]] = None

    def register_spec(self, tree: Any) -> None:
        """Pin the expected adapter structure (path → shape): a decoded
        uplink must match it exactly."""
        self.spec = {path: tuple(leaf.shape)
                     for path, leaf in flatten_with_paths(tree).items()}

    def encode(self, tree: Any, *, round_id: int, client_id: int,
               direction: str = "uplink",
               rank: Optional[int] = None) -> Payload:
        codec = self.quantize if direction == "uplink" else "none"
        with self.rec.span("codec.encode", cat="transport", round=round_id,
                           client=client_id, codec=codec):
            flat = flatten_with_paths(tree)
            if codec == "none":  # each leaf itself when float32
                tensors = {p: EncodedTensor(x.float())
                           for p, x in flat.items()}
            elif codec == "fp16":
                tensors = {p: EncodedTensor(x.to(torch.float16))
                           for p, x in flat.items()}
            else:
                tensors = dict(zip(flat, _int8_encode(list(flat.values()))))
        payload = Payload(round_id=round_id, client_id=client_id,
                          direction=direction, codec=codec, tensors=tensors,
                          rank=None if rank is None else int(rank))
        if self.rec.enabled:
            self.rec.counter(f"transport.{direction}_bytes").inc(
                payload.nbytes)
            self.rec.counter(f"transport.{direction}_payloads").inc()
        return payload

    @staticmethod
    def _decode_flat(payload: Payload) -> Dict[str, torch.Tensor]:
        """Dequantize the wire tensors; a wire buffer whose element count
        disagrees with its declared shape raises (reason ``bytes``)."""
        flat = {}
        for path, enc in payload.tensors.items():
            declared = enc.declared_shape
            expected = math.prod(declared)
            if enc.data.numel() != expected:
                raise TransportError(
                    f"{path}: wire buffer has {enc.data.numel()} elements "
                    f"({enc.data.numel() * enc.data.element_size()} B) but "
                    f"declares shape {declared} "
                    f"({expected} elements)", round_id=payload.round_id,
                    client_id=payload.client_id, reason="bytes")
            arr = enc.data.reshape(declared)
            if enc.scale is not None:
                flat[path] = arr.float() * enc.scale.float()
            else:
                flat[path] = arr.float()  # a float32 leaf: itself, no copy
        return flat

    def _validate_flat(self, payload: Payload,
                       flat: Dict[str, torch.Tensor]) -> None:
        """The ValidationPolicy stage: spec/shape, finite, ∞-norm ceiling,
        in the reference's order; one host sync for the whole payload."""
        v = self.validation
        if not v.enabled:
            return
        ctx = dict(round_id=payload.round_id, client_id=payload.client_id)
        if v.check_spec and self.spec is not None:
            self._check_spec(payload.rank, flat, ctx)
        check_finite, max_norm = v.check_finite, v.max_norm
        if not (check_finite or max_norm > 0) or not flat:
            return
        leaves = list(flat.values())
        stats = []
        if check_finite:
            stats.append(torch.stack([x.sum(dtype=torch.float64)
                                      for x in leaves]))
        if max_norm > 0:
            stats.append(torch.stack([
                x.abs().amax() if x.numel() else x.new_zeros(())
                for x in leaves]).double())
        host = torch.cat(stats).cpu().tolist()  # the payload's one sync
        sums = host[:len(leaves)] if check_finite else []
        absmax = host[-len(leaves):] if max_norm > 0 else []
        total = 0.0
        for i, path in enumerate(flat):
            # a finite float32 leaf cannot overflow its float64 sum, and
            # any NaN/±Inf makes it (and the running total) non-finite
            if check_finite:
                total += sums[i]
            if max_norm > 0 and absmax[i] > max_norm:
                raise TransportError(
                    f"{path}: ∞-norm {absmax[i]:.3g} exceeds limit "
                    f"{max_norm:g}", reason="norm", **ctx)
        if check_finite and not math.isfinite(total):
            bad = next((p for p, s in zip(flat, sums)
                        if not math.isfinite(s)), None)
            raise TransportError(
                f"{bad}: non-finite values in payload" if bad
                else "non-finite values in payload", reason="nonfinite",
                **ctx)

    def _check_spec(self, r: Optional[int], flat: Dict[str, torch.Tensor],
                    ctx: Dict[str, Any]) -> None:
        spec = self.spec
        if flat.keys() != spec.keys():
            missing = sorted(set(spec) - set(flat))
            extra = sorted(set(flat) - set(spec))
            raise TransportError(
                f"adapter tree mismatch vs registered spec "
                f"(missing={missing}, extra={extra})", reason="spec", **ctx)
        for path, arr in flat.items():
            want, got = spec[path], tuple(arr.shape)
            ax = self._rank_axis(path) if r is not None else None
            if ax is None:
                if got != want:
                    raise TransportError(
                        f"{path}: shape {got} != registered {want}",
                        reason="shape", **ctx)
                continue
            # a ragged (hetero) uplink: the factor's rank axis carries the
            # declared rank, zero-padded to the registered r_max after the
            # checks; an already padded tensor passes too
            r_max = want[len(want) + ax]
            if not 1 <= r <= r_max:
                raise TransportError(
                    f"{path}: declared rank {r} outside [1, {r_max}] "
                    f"(registered r_max)", reason="rank", **ctx)
            if len(got) != len(want) or any(
                    g != w for i, (g, w) in enumerate(zip(got, want))
                    if i != len(want) + ax):
                raise TransportError(
                    f"{path}: shape {got} != registered {want}",
                    reason="shape", **ctx)
            if got[ax] not in (r, r_max):
                raise TransportError(
                    f"{path}: rank axis has {got[ax]} columns, matching "
                    f"neither declared rank {r} nor registered r_max "
                    f"{r_max}", reason="rank", **ctx)

    @staticmethod
    def _rank_axis(path: str) -> Optional[int]:
        """The rank axis of a factor leaf: a is (…, m, r) → −1, b is
        (…, r, n) → −2; None for any other leaf."""
        return {"a": -1, "b": -2}.get(path.rsplit("/", 1)[-1])

    def _pad_ragged(self, payload: Payload, flat: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Zero-pad a validated ragged payload's factor leaves to the
        registered r_max shapes (the close masks the padded columns)."""
        if payload.rank is None or self.spec is None:
            return flat
        out = {}
        for path, arr in flat.items():
            want = self.spec.get(path)
            if want is not None and tuple(arr.shape) != want:
                padded = arr.new_zeros(want)
                padded[tuple(slice(0, g) for g in arr.shape)] = arr
                arr = padded
            out[path] = arr
        return out

    def decode(self, payload: Payload) -> Any:
        flat = self._decode_flat(payload)
        self._validate_flat(payload, flat)
        return unflatten_from_paths(self._pad_ragged(payload, flat))

    def decode_into(self, payload: Payload, buffers: Any, *,
                    weight: Optional[float] = None) -> Any:
        """Decode, validate and write into the sink's lane
        (:class:`~repro_torch.core.engine.RoundBuffers`), routed by the
        payload's ``round_id``; returns the decoded tree. Validation runs
        before the write, so a quarantined payload never touches a lane
        (raises :class:`TransportError`); a payload the ring refuses
        raises :class:`StaleUplinkError`. ``weight`` is the client's raw
        aggregation weight, which a chunked ring folds in at ingest."""
        with self.rec.span("codec.decode", cat="transport",
                           round=payload.round_id, client=payload.client_id,
                           codec=payload.codec, nbytes=payload.nbytes):
            flat = self._decode_flat(payload)
            self._validate_flat(payload, flat)
            flat = self._pad_ragged(payload, flat)
            rank_kw = {} if payload.rank is None else {"rank": payload.rank}
            ctx = dict(round_id=payload.round_id,
                       client_id=payload.client_id)
            try:
                landed = buffers.write_flat(payload.client_id, flat,
                                            round_id=payload.round_id,
                                            weight=weight, **rank_kw)
            except KeyError as e:
                raise StaleUplinkError(f"unroutable round_id: {e}",
                                       reason="unroutable", **ctx) from e
            if not landed:
                raise StaleUplinkError(
                    "ring refused the write (stale/evicted round or "
                    "duplicate lane)", reason="stale", **ctx)
        now = time.perf_counter_ns()
        with self._ingest_lock:
            if self._ingest_t0 is None:
                self._ingest_t0 = now
            self._ingest_bytes += payload.nbytes
            ingest_bytes, t0 = self._ingest_bytes, self._ingest_t0
        if self.rec.enabled:
            elapsed_s = max((now - t0) / 1e9, 1e-9)
            self.rec.gauge("uplink.ingest_bytes_per_s").set(
                round(ingest_bytes / elapsed_s, 1))
        return unflatten_from_paths(flat)


@dataclass
class LedgerEntry:
    round_id: int
    direction: str
    client_id: int
    params: int
    nbytes: int
    codec: str
    note: str = ""


class BytesLedger:
    """Per-round communication ledger (measured params + bytes).

    Besides ``uplink``/``downlink``, a quarantined uplink is recorded under
    ``quarantined`` and a refused one under ``dropped`` (so is the downlink
    that fed a client who never delivered): :meth:`reconcile` compares only
    the delivered uplink/downlink params against the analytic form.
    """

    def __init__(self):
        self.entries: List[LedgerEntry] = []

    def record(self, payload: Payload, note: str = "",
               direction: Optional[str] = None) -> None:
        """Record one payload; ``direction`` overrides the payload's own."""
        self.entries.append(LedgerEntry(
            round_id=payload.round_id,
            direction=direction or payload.direction,
            client_id=payload.client_id, params=payload.num_params,
            nbytes=payload.nbytes, codec=payload.codec, note=note))

    def reclassify(self, round_id: int, client_id: int, direction: str,
                   new_direction: str, note: str = "") -> bool:
        """Re-bucket the latest matching entry; returns whether one was
        found."""
        for e in reversed(self.entries):
            if (e.round_id == round_id and e.client_id == client_id
                    and e.direction == direction):
                e.direction = new_direction
                if note:
                    e.note = (e.note + "; " + note) if e.note else note
                return True
        return False

    def record_analytic(self, round_id: int, direction: str, params: int,
                        bytes_per_param: int = 4, client_id: int = -1,
                        note: str = "") -> None:
        """Account a payload modelled analytically (the factored residual
        broadcast, the float32 downlink)."""
        self.entries.append(LedgerEntry(
            round_id=round_id, direction=direction, client_id=client_id,
            params=int(params), nbytes=int(params) * bytes_per_param,
            codec="none", note=note))

    def record_raw(self, round_id: int, direction: str, nbytes: int,
                   client_id: int = -1, note: str = "") -> None:
        """Account octets that carry no adapter parameters (params = 0)
        under their own direction."""
        self.entries.append(LedgerEntry(
            round_id=round_id, direction=direction, client_id=client_id,
            params=0, nbytes=int(nbytes), codec="raw", note=note))

    def round_totals(self, round_id: int) -> Dict[str, int]:
        """``{direction}_params`` / ``{direction}_bytes`` sums of one round;
        the four uplink/downlink keys are always present."""
        tot = {"uplink_params": 0, "uplink_bytes": 0,
               "downlink_params": 0, "downlink_bytes": 0}
        for e in self.entries:
            if e.round_id != round_id:
                continue
            kp, kb = f"{e.direction}_params", f"{e.direction}_bytes"
            tot[kp] = tot.get(kp, 0) + e.params
            tot[kb] = tot.get(kb, 0) + e.nbytes
        return tot

    def totals(self) -> Dict[str, int]:
        out = {"uplink_params": 0, "uplink_bytes": 0,
               "downlink_params": 0, "downlink_bytes": 0}
        for r in {e.round_id for e in self.entries}:
            for key, v in self.round_totals(r).items():
                out[key] = out.get(key, 0) + v
        return out

    def reconcile(self, round_id: int, analytic: Dict[str, int]
                  ) -> Dict[str, Any]:
        """Measured param counts against ``round_comm_params``' closed form
        (params only: bytes depend on the codec)."""
        got = self.round_totals(round_id)
        out: Dict[str, Any] = {}
        for direction in ("uplink", "downlink"):
            measured = got[f"{direction}_params"]
            expected = int(analytic.get(direction, 0))
            out[direction] = {"measured": measured, "analytic": expected,
                              "match": measured == expected}
        out["ok"] = all(out[d]["match"] for d in ("uplink", "downlink"))
        return out

    def state_dict(self) -> List[Dict[str, Any]]:
        return [asdict(e) for e in self.entries]

    def load_state(self, state: List[Dict[str, Any]]) -> None:
        self.entries = [LedgerEntry(**d) for d in state]

    def summary_lines(self) -> List[str]:
        rounds = sorted({e.round_id for e in self.entries})
        lines = [f"{'round':>5} {'up_params':>10} {'up_bytes':>10} "
                 f"{'down_params':>11} {'down_bytes':>10}"]
        for r in rounds:
            t = self.round_totals(r)
            lines.append(f"{r:>5} {t['uplink_params']:>10} "
                         f"{t['uplink_bytes']:>10} "
                         f"{t['downlink_params']:>11} "
                         f"{t['downlink_bytes']:>10}")
        t = self.totals()
        lines.append(f"{'all':>5} {t['uplink_params']:>10} "
                     f"{t['uplink_bytes']:>10} {t['downlink_params']:>11} "
                     f"{t['downlink_bytes']:>10}")
        return lines
