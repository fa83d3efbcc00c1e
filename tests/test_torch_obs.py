"""The port's observability layer (``repro_torch.obs``) against the JAX
reference's (``repro.obs``).

* metrics: the same observations through both registries give equal
  snapshots and histogram summaries;
* the tracer: nesting, thread ids and the Chrome export's structure, as the
  reference's;
* ``obs="off"`` uses the shared no-op ``NULL`` everywhere;
* trainer level, each package with ``obs="trace"`` at ``paper-tiny``
  (vocab 64, 2 local steps, 2 rounds, the reference's draws carried across
  with ``repro_torch.bridge``): a weighted fedex run at 50% participation
  with a deadline, dropout and stragglers, an int8 run under a fault plan, a
  chunked run and a FedBuff run. Every round record's non-timing fields are
  equal exactly (client counts, ring counts, bytes and params, ``comm_match``,
  ``chunked``, ``partial_folds``, ``peak_bytes``, ``global_finite``, the sim
  clock), ``divergence`` within rtol 1e-3 (``tests/test_torch_federated.
  py``'s tolerance) and atol 1e-8, the f32 noise of a round whose clients
  still hold nearly the same adapters (round 0: b starts at 0), and
  ``eval_loss`` / ``eval_acc`` within rtol 1e-5; the counters, the gauges but the ingest rate, the histograms'
  counts and the span and event names are equal, leaving out the
  reference's ``compile_*`` names (the port compiles no close program) and
  the timings;
* inside the port, ``obs="trace"`` is bitwise ``obs="off"``;
* ``scripts/obs_report.py --check`` passes on the port's streams with the
  overlap invariant proven, and ``--chaos`` on the faulted run, whose
  ``clean_exact`` stamps come from its crash twin;
* the launcher's ``--obs`` / ``--trace`` / ``--metrics-out``.
"""

import dataclasses
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import FedConfig as JFedConfig  # noqa: E402
from repro.configs import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.launch.train import build_federated_data as jax_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.train import build_federated_data  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import NULL, MetricsRegistry, Tracer  # noqa: E402
from repro_torch.util.tree import flatten_with_paths  # noqa: E402

CPU = torch.device("cpu")
VOCAB, STEPS, ROUNDS, SEQ = 64, 2, 2, 32
TRAIN = dict(learning_rate=5e-3, schedule="constant",
             total_steps=ROUNDS * STEPS)
FAULTS = ("truncate@1(clients=1);decode_error@1(clients=0,count=1);"
          "duplicate@1(clients=2);crash@1(clients=3)")
TWIN = "crash@1(clients=1+3)"
# (clients, FedConfig settings). Seed 0's draws in the weighted run: 4 of
# 8 sampled, dropouts, stragglers and a deadline drop
CASES = {
    "weighted": (8, dict(participation=0.5, weighting="examples",
                         round_deadline=1.0, min_quorum=2, dropout_prob=0.25,
                         straggler_prob=0.5)),
    "int8+faults": (4, dict(quantize_uplink="int8", faults=FAULTS)),
    "chunked": (4, dict(close_chunk=2, weighting="examples")),
    "fedbuff": (4, dict(async_buffer=2, weighting="examples")),
}
TIMINGS = {"close_dispatch_us", "close_block_us", "compile_miss"}
FLOAT_FIELDS = {"divergence": (1e-3, 1e-8), "eval_loss": (1e-5, 0.0),
                "eval_acc": (1e-5, 0.0)}
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "obs_report.py"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obs_report():
    spec = importlib.util.spec_from_file_location("obs_report", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# one reference model, its init jitted (the port starts from whatever it
# draws), and one compiled local step and eval for every reference run
_JAX = {}


def _jax_model():
    if "model" not in _JAX:
        model = jax_build_model(dataclasses.replace(
            jax_get_config("paper-tiny"), vocab_size=VOCAB, dtype="float32"))
        object.__setattr__(model, "init", jax.jit(model.init))  # frozen
        _JAX["model"] = model
    return _JAX["model"]


def _jax_run(clients, fed_kw):
    jl, je = jax_data(VOCAB, clients, seed=0, seq_len=SEQ)
    jt = JaxTrainer(model=_jax_model(), lora_cfg=JLoRAConfig(),
                    fed_cfg=JFedConfig(engine="jnp", num_clients=clients,
                                       rounds=ROUNDS, local_steps=STEPS,
                                       obs="trace", **fed_kw),
                    train_cfg=JTrainConfig(**TRAIN), client_loaders=jl,
                    eval_batches=je[:1], seed=0)
    if "fns" in _JAX:
        jt.local_step, jt.eval_fn = _JAX["fns"]
    else:
        _JAX["fns"] = (jt.local_step, jt.eval_fn)
    start = (_np(jt.params), _np(jt.global_lora))
    jt.run()
    return jt, start


def _port(clients, fed_kw, start, obs="trace"):
    cfg = dataclasses.replace(get_config("paper-tiny"), vocab_size=VOCAB,
                              dtype="float32")
    pl, pe = build_federated_data(VOCAB, clients, seed=0, seq_len=SEQ,
                                  device=CPU)
    return FederatedTrainer(
        model=build_model(cfg), lora_cfg=LoRAConfig(),
        fed_cfg=FedConfig(num_clients=clients, rounds=ROUNDS,
                          local_steps=STEPS, obs=obs, **fed_kw),
        train_cfg=TrainConfig(**TRAIN), client_loaders=pl,
        eval_batches=pe[:1], seed=0, device=CPU,
        params=params_from_numpy(start[0], CPU),
        global_lora=params_from_numpy(start[1], CPU))


@pytest.fixture(scope="module")
def runs():
    """name → (reference trainer, port trainer, start draws), both run under
    trace. Set up before the function-scoped ``_one_torch_thread``, so it
    pins torch to one thread itself."""
    out, n = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (clients, kw) in CASES.items():
            jt, start = _jax_run(clients, kw)
            pt = _port(clients, kw, start)
            pt.run()
            out[name] = (jt, pt, start)
    finally:
        torch.set_num_threads(n)
    return out


# --------------------------------------------------------------------------
# metrics, tracer, NULL
# --------------------------------------------------------------------------

def _observe(reg):
    reg.counter("ring.evictions").inc()
    reg.counter("transport.uplink_bytes").inc(4096)
    reg.counter("transport.uplink_bytes").inc(12)
    reg.gauge("ring.occupancy").set(2)
    reg.gauge("ring.occupancy").set(1)
    for v in (3.5, 1.25, 9.0, 0.5):
        reg.hist("engine.close_block_us").observe(v)
    reg.hist("empty")
    return reg


def test_metrics_match_reference():
    port, ref = _observe(MetricsRegistry()), _observe(JRegistry())
    assert port.snapshot() == ref.snapshot()
    assert port.names() == ref.names()
    h = port.hist("engine.close_block_us").summary()
    assert h == ref.hist("engine.close_block_us").summary()
    assert h["count"] == 4 and h["max"] == 9.0
    with pytest.raises(TypeError):
        port.gauge("ring.evictions")  # a counter already
    with pytest.raises(ValueError):
        port.counter("ring.evictions").inc(-1)


def _trace(tracer):
    with tracer.span("round.close", cat="trainer", run="a", round=0):
        with tracer.span("close.dispatch", cat="engine", round=0):
            pass
        tracer.instant("ring.begin", cat="ring", round=1)
    worker = threading.Thread(target=lambda: tracer.span(
        "ring.write", round=1).__enter__().__exit__(None, None, None))
    worker.start()
    worker.join()
    return tracer


def _shape(chrome):
    """The Chrome export without its times and thread idents."""
    out = []
    for ev in chrome["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        if ev["name"] == "thread_name":
            ev["args"] = {"name": ev["args"]["name"].split(" ")[0]}
        out.append(ev)
    return out


def test_tracer_nesting_threads_and_chrome_export():
    port = _trace(Tracer(device_annotations=True))
    ref = _trace(JTracer())
    spans = {s["name"]: s for s in port.spans}
    outer, inner = spans["round.close"], spans["close.dispatch"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["run"] == "a" and outer["args"] == {"round": 0}
    assert outer["tid"] == inner["tid"] == 0
    assert spans["ring.write"]["tid"] == 1
    assert [s["name"] for s in port.spans] == [s["name"] for s in ref.spans]
    chrome = port.to_chrome()
    assert _shape(chrome) == _shape(ref.to_chrome())
    assert chrome["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in chrome["traceEvents"]} == {"M", "X", "i"}
    # a span is a profiler range only while a profiler records
    span = port.span("close.dispatch")
    with span:
        assert span._ann is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port.span("close.dispatch", round=2):
            torch.ones(3).sum()
    assert "close.dispatch" in {e.key for e in prof.key_averages()}


def test_obs_off_is_the_shared_null(runs):
    clients, kw = CASES["fedbuff"]
    pt = _port(clients, kw, runs["fedbuff"][2], obs="off")
    assert pt.recorder is NULL
    assert pt.engine.rec is NULL and pt.engine.buffers.rec is NULL
    assert pt.coordinator.rec is NULL and pt.coordinator.codec.rec is NULL
    pt.run()
    assert pt.recorder.round_records() == []


# --------------------------------------------------------------------------
# trainer level against the reference
# --------------------------------------------------------------------------

def _assert_records_match(jrecs, precs):
    assert len(jrecs) == len(precs) == ROUNDS
    for jr, pr in zip(jrecs, precs):
        jkeys = set(jr) - TIMINGS
        assert set(pr) - TIMINGS == jkeys, (sorted(jkeys ^ set(pr)))
        for k in sorted(jkeys):
            if k in FLOAT_FIELDS:
                rtol, atol = FLOAT_FIELDS[k]
                np.testing.assert_allclose(pr[k], jr[k], rtol=rtol,
                                           atol=atol, err_msg=k)
            else:
                assert pr[k] == jr[k], (jr["round"], k, pr[k], jr[k])
        assert "close_dispatch_us" in pr and "close_block_us" in pr


def _no_compile(names):
    return {n for n in names if ".compile" not in n}


@pytest.mark.parametrize("name", list(CASES))
def test_round_records_and_counters_match_reference(runs, name):
    jt, pt, _ = runs[name]
    jrec, prec = jt.recorder, pt.recorder
    _assert_records_match(jrec.round_records(), prec.round_records())
    js, ps = jrec.metrics.snapshot(), prec.metrics.snapshot()
    jc = {k: v for k, v in js["counters"].items() if ".compile" not in k}
    assert ps["counters"] == jc
    skip = {"uplink.ingest_bytes_per_s", "engine.compile_cache_size"}
    assert ({k: v for k, v in ps["gauges"].items() if k not in skip}
            == {k: v for k, v in js["gauges"].items() if k not in skip})
    assert ({k: h["count"] for k, h in ps["histograms"].items()}
            == {k: h["count"] for k, h in js["histograms"].items()})
    if "fedsrv.commit_staleness" in js["histograms"]:
        assert (ps["histograms"]["fedsrv.commit_staleness"]
                == js["histograms"]["fedsrv.commit_staleness"])
    jtr, ptr = jrec.tracer, prec.tracer
    assert ({s["name"] for s in ptr.spans}
            == _no_compile({s["name"] for s in jtr.spans}))
    assert ({e["name"] for e in ptr.events}
            == _no_compile({e["name"] for e in jtr.events}))
    # what each case must exercise
    counters, recs = ps["counters"], prec.round_records()
    if name == "weighted":
        assert all(r["dropped_out"] for r in recs)
        assert sum(r["stragglers"] for r in recs) >= 1
        assert sum(r["deadline_drops"] for r in recs) >= 1
    if name == "int8+faults":
        assert counters["uplink.quarantined[bytes]"] == ROUNDS
        assert counters["uplink.dropped[crash]"] == ROUNDS
        assert counters["uplink.retries"] == ROUNDS
        assert all(r["global_finite"] == 1 for r in recs)
    if name == "chunked":
        assert all(r["chunked"] == 1 and r["partial_folds"] == 2
                   for r in recs)
    assert all(r["comm_match"] == 1 for r in recs)


@pytest.mark.parametrize("name", list(CASES))
def test_trace_is_bitwise_obs_off(runs, name):
    clients, kw = CASES[name]
    _, traced, start = runs[name]
    off = _port(clients, kw, start, obs="off")
    off.run()
    for a, b in ((traced.params, off.params),
                 (traced.global_lora, off.global_lora)):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert ([dataclasses.astuple(r) for r in traced.history]
            == [dataclasses.astuple(r) for r in off.history])


@pytest.mark.parametrize("name", ["weighted", "chunked", "fedbuff"])
def test_obs_report_check_proves_overlap(runs, name, tmp_path, capsys):
    rec = runs[name][1].recorder
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    rec.write_metrics(str(metrics))
    rec.write_trace(str(trace))
    report = _obs_report()
    assert report.main([str(metrics), "--trace", str(trace), "--check"]) == 0
    out = capsys.readouterr().out
    assert "overlap invariant proven" in out
    witness = "close.partial_fold" if name == "chunked" else "ring.write"
    assert f"round=0→1: " in out and witness in out


def test_obs_report_chaos_on_the_faulted_run(runs, tmp_path):
    """The faulted run against its crash twin (clients 1 and 3 crash every
    round): each round's history entry equal and the final params and
    global adapter bitwise equal stamp ``clean_exact``, and ``--check
    --chaos`` passes on the stream (the overlap proven too)."""
    clients, kw = CASES["int8+faults"]
    faulty = runs["int8+faults"][1]
    twin = _port(clients, dict(kw, faults=TWIN), runs["int8+faults"][2],
                 obs="off")
    twin.run()
    final = all(
        torch.equal(x, flatten_with_paths(b)[k])
        for a, b in ((faulty.params, twin.params),
                     (faulty.global_lora, twin.global_lora))
        for k, x in flatten_with_paths(a).items())
    same = [final and dataclasses.astuple(f) == dataclasses.astuple(t)
            for f, t in zip(faulty.history, twin.history)]
    assert same == [True] * ROUNDS
    metrics = tmp_path / "m.jsonl"
    faulty.recorder.write_metrics(str(metrics))
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    for r in recs:
        if r["type"] == "round":
            r["clean_exact"] = int(same[r["round"]])
    metrics.write_text("".join(json.dumps(r) + "\n" for r in recs))
    report = _obs_report()
    assert report.main([str(metrics), "--check", "--chaos"]) == 0
    assert recs[0]["type"] == "meta" and recs[0]["platform"] == "cpu"


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_obs_flags(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    train_launcher.main(["--device", "cpu", "--vocab", str(VOCAB),
                         "--clients", "3", "--rounds", "2",
                         "--local-steps", "1", "--seq-len", str(SEQ),
                         "--obs", "trace", "--trace", str(trace),
                         "--metrics-out", str(metrics)])
    assert "obs mode=trace: 2 round record(s)" in capsys.readouterr().out
    assert json.loads(trace.read_text())["traceEvents"]
    report = _obs_report()
    assert report.main([str(metrics), "--trace", str(trace), "--check"]) == 0
    basic = tmp_path / "b.jsonl"
    train_launcher.main(["--device", "cpu", "--vocab", str(VOCAB),
                         "--clients", "2", "--rounds", "1",
                         "--local-steps", "1", "--seq-len", str(SEQ),
                         "--metrics-out", str(basic)])
    meta = json.loads(basic.read_text().splitlines()[0])
    assert meta["mode"] == "basic"
    with pytest.raises(SystemExit):
        train_launcher.main(["--device", "cpu", "--trace", str(trace),
                             "--obs", "basic"])
