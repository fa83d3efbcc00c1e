"""The recorder facade: one object every layer records through.

``make_recorder(mode)`` returns one of:

* ``off``   → the shared :data:`NULL` no-op recorder (a few attribute reads
  and no-op calls per round — nothing is allocated, timed, or stored);
* ``basic`` → metrics only: counters/gauges/histograms + per-round records
  (close latency, ring/ledger stats) with NO span collection;
* ``trace`` → everything in basic plus host spans (obs.tracer) nested in
  ``torch.profiler.record_function`` ranges, exportable as Chrome
  trace-event JSON.

The port's copy of ``repro/obs/recorder.py``. Recording never waits for the
device: a field that would need a device value is stamped only where the
code already holds it on the host (the divergence after its one sync in
``DeferredDivergence.resolve``).

Per-round records are keyed by ``(run, round_id)`` — ``set_run(label)``
namespaces rounds when one process drives several runs (the scenario demo,
sweeps), so round 0 of scenario 2 never merges into round 0 of scenario 1.

The JSONL metrics stream (``write_metrics``) is the contract consumed by
``scripts/obs_report.py``: one JSON object per line with a ``type`` field —
``meta`` (torch / CUDA / device info), ``counters`` (the registry snapshot), ``round``
(one per (run, round)), ``span`` / ``event`` (trace mode only, timestamps in
µs relative to the tracer origin).
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer

OBS_MODES = ("off", "basic", "trace")


class _NullSpan:
    """Reusable no-op context manager (one shared instance, zero allocs)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


class _NullMetric:
    """No-op stand-in for Counter/Gauge/Histogram (shared instance)."""

    __slots__ = ()
    value = 0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


_NULL_SPAN = _NullSpan()
_NULL_METRIC = _NullMetric()


class NullRecorder:
    """The ``obs=off`` recorder: every call is a no-op returning shared
    singletons. Instrumented code can call it unconditionally; hot paths may
    additionally guard on ``recorder.enabled`` to skip building kwargs."""

    enabled = False
    tracing = False
    mode = "off"
    run: Optional[str] = None

    def set_run(self, label: Optional[str]) -> None:
        pass

    def span(self, name: str, cat: str = "host", **args) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, cat: str = "host", **args) -> None:
        pass

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def hist(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def round_set(self, round_id, **fields) -> None:
        pass

    def round_inc(self, round_id, key: str, n=1) -> None:
        pass

    def round_records(self) -> List[Dict[str, Any]]:
        return []

    def write_trace(self, path: str) -> None:
        pass

    def write_metrics(self, path: str) -> None:
        pass


NULL = NullRecorder()


class Recorder:
    """Live recorder: metrics registry + per-round records (+ tracer)."""

    enabled = True

    def __init__(self, mode: str = "trace", device=None):
        if mode not in ("basic", "trace"):
            raise ValueError(f"recorder mode must be basic|trace, got {mode!r}"
                             " (off → use obs.NULL / make_recorder)")
        self.mode = mode
        self.device = device  # named in the meta record
        self.tracing = mode == "trace"
        self.tracer = Tracer(device_annotations=True) if self.tracing else None
        self.metrics = MetricsRegistry()
        self.run: Optional[str] = None
        # (run, round_id) → field dict, insertion-ordered
        self._rounds: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._created_ns = time.perf_counter_ns()

    # -- run namespacing ----------------------------------------------------
    def set_run(self, label: Optional[str]) -> None:
        """Namespace subsequent rounds/spans under ``label`` (multi-run
        processes: scenario demos, sweeps). ``None`` clears it."""
        self.run = label

    # -- spans / events -----------------------------------------------------
    def span(self, name: str, cat: str = "host", **args):
        if self.tracer is not None:
            return self.tracer.span(name, cat, run=self.run, **args)
        return _NULL_SPAN

    def event(self, name: str, cat: str = "host", **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, cat, run=self.run, **args)

    # -- metrics ------------------------------------------------------------
    def counter(self, name: str):
        return self.metrics.counter(name)

    def gauge(self, name: str):
        return self.metrics.gauge(name)

    def hist(self, name: str):
        return self.metrics.hist(name)

    # -- per-round records --------------------------------------------------
    def _round(self, round_id) -> Dict[str, Any]:
        key = (self.run, round_id)
        rec = self._rounds.get(key)
        if rec is None:
            rec = self._rounds[key] = {"run": self.run, "round": round_id}
        return rec

    def round_set(self, round_id, **fields) -> None:
        self._round(round_id).update(fields)

    def round_inc(self, round_id, key: str, n=1) -> None:
        rec = self._round(round_id)
        rec[key] = rec.get(key, 0) + n

    def round_records(self) -> List[Dict[str, Any]]:
        return [dict(rec) for rec in self._rounds.values()]

    # -- export -------------------------------------------------------------
    def write_trace(self, path: str, process_name: str = "repro") -> None:
        if self.tracer is None:
            raise ValueError("write_trace needs mode='trace' "
                             f"(recorder mode is {self.mode!r})")
        self.tracer.write_chrome_trace(path, process_name)

    def metrics_records(self) -> List[Dict[str, Any]]:
        """Every JSONL record, in stream order (meta, counters, rounds,
        then spans/events when tracing)."""
        out: List[Dict[str, Any]] = [
            {"type": "meta", "mode": self.mode,
             **_env_meta(self.device)},
            {"type": "counters", **self.metrics.snapshot()},
        ]
        for rec in self._rounds.values():
            out.append({"type": "round", **rec})
        if self.tracer is not None:
            for s in self.tracer.spans:
                out.append({"type": "span", "name": s["name"],
                            "cat": s["cat"], "run": s["run"],
                            "tid": s["tid"], "ts_us": s["ts"] / 1e3,
                            "dur_us": s["dur"] / 1e3, "args": s["args"]})
            for e in self.tracer.events:
                out.append({"type": "event", "name": e["name"],
                            "cat": e["cat"], "run": e["run"],
                            "tid": e["tid"], "ts_us": e["ts"] / 1e3,
                            "args": e["args"]})
        return out

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.metrics_records():
                f.write(json.dumps(rec) + "\n")

    def summary_lines(self) -> List[str]:
        """Human-readable end-of-run digest (the launcher logs these)."""
        snap = self.metrics.snapshot()
        lines = [f"obs mode={self.mode}: {len(self._rounds)} round record(s)"]
        for name, v in snap["counters"].items():
            lines.append(f"  counter {name} = {v}")
        for name, v in snap["gauges"].items():
            lines.append(f"  gauge   {name} = {v}")
        for name, s in snap["histograms"].items():
            if s.get("count"):
                lines.append(f"  hist    {name}: n={s['count']} "
                             f"mean={s['mean']:.1f} max={s['max']:.1f}")
        return lines


def _env_meta(device=None) -> Dict[str, Any]:
    """torch's and CUDA's versions and the recording device's name."""
    dev = torch.device("cpu" if device is None else device)
    cuda = dev.type == "cuda" and torch.cuda.is_available()
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "platform": "gpu" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1}


def make_recorder(mode: str = "off", device=None):
    """``off`` → the shared no-op :data:`NULL`; else a live Recorder whose
    meta record names ``device``."""
    if mode not in OBS_MODES:
        raise ValueError(f"obs mode must be one of {OBS_MODES}, got {mode!r}")
    if mode == "off":
        return NULL
    return Recorder(mode, device)
