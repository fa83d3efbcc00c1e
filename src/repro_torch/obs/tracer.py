"""Host-side span tracer with Chrome trace-event export.

The port's copy of ``repro/obs/tracer.py``. Spans are measured with
``time.perf_counter_ns`` (monotonic, ns resolution) and tagged with the
recording thread, so the HTTP service's handler threads render as separate
tracks. With ``device_annotations`` (the recorder's ``trace`` mode) every
host span entered while a ``torch.profiler`` is recording also enters a
``torch.profiler.record_function`` range, so the profiler's trace of the
card shows the same names (``close.dispatch`` around the ``fedex_fold``
launches) — the reference nests its spans in
``jax.profiler.TraceAnnotation`` the same way. With no profiler recording
no range is entered (it would cost host time and show nowhere).

Export targets, in the reference's formats:

* **Chrome trace-event JSON** (``write_chrome_trace``): the ``traceEvents``
  array, loadable in Perfetto or ``chrome://tracing``. Spans are complete
  events (``ph="X"`` with ``ts`` / ``dur`` in microseconds); instants are
  ``ph="i"``.
* **JSONL records** (via :mod:`repro_torch.obs.recorder`): one JSON object
  per span/event, timestamps in µs relative to the tracer's origin — the
  stream ``scripts/obs_report.py`` summarizes and checks.

A span records host time only: entering or leaving one never waits for the
device.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch


class Span:
    """One in-flight span; a context manager recorded on exit.

    Created by :meth:`Tracer.span`; not reusable. Exceptions propagate (the
    span still records, so a trace shows where a round died).
    """

    __slots__ = ("_tracer", "name", "cat", "run", "args", "_start", "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 run: Optional[str], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.run = run
        self.args = args
        self._start = 0
        self._ann = None

    def __enter__(self) -> "Span":
        if (self._tracer.device_annotations
                and torch.autograd._profiler_enabled()):
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._start = self._tracer._now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self._tracer._now()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        self._tracer._record_span(self, self._start, end)


class Tracer:
    """Collects spans + instant events; exports Chrome trace-event JSON.

    All timestamps are ns relative to the tracer's construction time.
    Appends are GIL-atomic list ops — safe for several recording threads.
    """

    def __init__(self, device_annotations: bool = False):
        self.device_annotations = device_annotations
        self._t0 = time.perf_counter_ns()
        # recorded span dicts: name/cat/run/ts/dur (ns)/tid/args
        self.spans: List[Dict[str, Any]] = []
        # instant event dicts: name/cat/run/ts (ns)/tid/args
        self.events: List[Dict[str, Any]] = []
        self._tids: Dict[int, int] = {}  # thread ident → small track id
        self._tid_lock = threading.Lock()

    def _now(self) -> int:
        return time.perf_counter_ns() - self._t0

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record_span(self, span: Span, start: int, end: int) -> None:
        self.spans.append({
            "name": span.name, "cat": span.cat, "run": span.run,
            "ts": start, "dur": end - start, "tid": self._tid(),
            "args": span.args,
        })

    def span(self, name: str, cat: str = "host", run: Optional[str] = None,
             **args: Any) -> Span:
        """A new span context manager (records on exit)."""
        return Span(self, name, cat, run, args)

    def instant(self, name: str, cat: str = "host",
                run: Optional[str] = None, **args: Any) -> None:
        """Record a zero-duration instant event."""
        self.events.append({
            "name": name, "cat": cat, "run": run, "ts": self._now(),
            "tid": self._tid(), "args": args,
        })

    def to_chrome(self, process_name: str = "repro") -> Dict[str, Any]:
        """The Chrome trace-event dict: ``{"traceEvents": [...]}``.

        Spans become complete events (``ph="X"``, µs), instants ``ph="i"``
        with thread scope. Thread-name metadata events label each track.
        """
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": process_name},
        }]
        for ident, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": f"host-{tid} ({ident})"},
            })
        for s in self.spans:
            args = dict(s["args"])
            if s["run"] is not None:
                args["run"] = s["run"]
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "ts": s["ts"] / 1e3, "dur": s["dur"] / 1e3,
                "pid": 0, "tid": s["tid"], "args": args,
            })
        for e in self.events:
            args = dict(e["args"])
            if e["run"] is not None:
                args["run"] = e["run"]
            events.append({
                "name": e["name"], "cat": e["cat"], "ph": "i", "s": "t",
                "ts": e["ts"] / 1e3, "pid": 0, "tid": e["tid"], "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str,
                           process_name: str = "repro") -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
