"""obs — round-lifecycle tracing + metrics of the port (the counterpart of
``repro/obs``).

* :mod:`repro_torch.obs.tracer` — host spans (``perf_counter_ns``,
  thread-aware) in ``torch.profiler.record_function`` ranges, exported as
  Chrome trace-event JSON and a JSONL stream;
* :mod:`repro_torch.obs.metrics` — typed counters / gauges / histograms
  behind a get-or-create registry;
* :mod:`repro_torch.obs.recorder` — the facade every layer records through:
  ``make_recorder("off")`` returns the shared no-op :data:`NULL`, ``basic``
  collects metrics and per-round records, ``trace`` adds spans.

Instrumented layers: the coordinators (round open → uplinks → quorum /
deadline → close, FedBuff commits), the engine (the close's dispatch and
the divergence's resolution as separate spans, the ring's
begin / write / take / evict, the chunked ring's partial folds, the
analytic peak close bytes), the codec (encode / decode bytes), the fault
injector, the trainer (round close and eval, the ledger reconciled against
``repro_torch.core.comm``) and the HTTP service. Wired up through
``FedConfig.obs`` and the launcher's ``--obs`` / ``--trace`` /
``--metrics-out``; ``scripts/obs_report.py`` reads the stream.

On the card the close splits into ``close_dispatch_us`` (the host's
launches) and ``close_block_us`` (the wait for the device, in
``DeferredDivergence.resolve``, at the next round boundary), and round
N+1's ``ring.write`` spans fall inside round N's close window.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.recorder import (NULL, OBS_MODES, NullRecorder, Recorder,
                                      make_recorder)
from repro_torch.obs.tracer import Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL",
           "NullRecorder", "OBS_MODES", "Recorder", "Span", "Tracer",
           "make_recorder"]
