"""The port's HTTP federation service (``repro_torch.fedsrv.server``,
``.client``, ``.wire``) against the JAX reference's.

* Wire frames: the port's frame of a payload is byte-identical to the
  reference's (none, fp16, int8 and a ragged rank-1 payload), each package
  parses the other's, and malformed frames are refused with
  ``reason="wire"``.
* The reference's ``tests/test_server.py`` on the port: an HTTP round closes
  bitwise like an in-process twin engine fed the same deltas (its W0 digest
  equal too), for fedex, example weights, a wall-clock deadline closing at
  quorum through ``tick`` and ragged hetero rounds; every status (401, 403,
  400, 409, 410, 422, 429); the ``http_overhead`` reconciliation; the wall
  clock.
* Across frameworks: the same deltas POSTed to the port's server by the
  reference's ``FedClient`` and to the reference's server by the port's
  give equal statuses, versions and ledger totals (the HTTP overhead, which
  holds each server's port number in its ``Host`` header, left out), and
  pulled adapters and W0 within atol 1e-6 and rtol 1e-5 (f32 folds in two
  frameworks).
* ``tests/test_concurrent_ingest.py`` on the port's ring: threads writing
  lose no lane, a duplicate race has one winner, the threaded close is
  bitwise the serial one, and concurrent ``decode_into`` lands every lane.
* ``serve(pull_from=url)`` generates the tokens of ``serve`` given the
  twin's adapter.

Servers run in process on ephemeral ports.
"""

import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.fedsrv.client import FedClient as JFedClient  # noqa: E402
from repro.fedsrv.server import FederationServer as JServer  # noqa: E402
from repro.fedsrv.server import \
    start_http_server as jax_start_http_server  # noqa: E402
from repro.fedsrv.transport import AdapterCodec as JCodec  # noqa: E402
from repro.fedsrv.wire import payload_from_wire as jax_from_wire  # noqa: E402
from repro.fedsrv.wire import payload_to_wire as jax_to_wire  # noqa: E402
from repro_torch.configs import (FedConfig, LoRAConfig,  # noqa: E402
                                 ServeConfig, get_config)
from repro_torch.core.engine import RoundBuffers  # noqa: E402
from repro_torch.core.engine import RoundCloseEngine  # noqa: E402
from repro_torch.core.hetero import pad_adapters  # noqa: E402
from repro_torch.core.lora import init_global_state  # noqa: E402
from repro_torch.fedsrv import (AdapterCodec, FedClient,  # noqa: E402
                                Payload, SimClock, StaleUplinkError,
                                TransportError, ValidationPolicy)
from repro_torch.fedsrv.server import (FederationServer,  # noqa: E402
                                       hetero_w0_digest, start_http_server,
                                       w0_digest)
from repro_torch.fedsrv.wire import (payload_from_wire,  # noqa: E402
                                     payload_to_wire)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.util.tree import (flatten_with_paths,  # noqa: E402
                                   unflatten_from_paths)

CPU = torch.device("cpu")
M, N, R = 8, 6, 2
HET_RANKS = (1, 2, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see tests/test_torch_baselines.
    py: many-threaded small ops crawl under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"blk": {"q": {"kernel": rng.normal(size=(M, N)).astype(
        np.float32)}}}


def _params(seed=0):
    return {"blk": {"q": {"kernel": torch.from_numpy(
        _np_params(seed)["blk"]["q"]["kernel"])}}}


def _template():
    return {"blk": {"q": {"a": torch.zeros(M, R), "b": torch.zeros(R, N)}}}


def _np_delta(rnd, cid, r=R, seed=42):
    g = np.random.default_rng([seed, rnd, cid])
    return {"blk": {"q": {"a": g.normal(size=(M, r)).astype(np.float32),
                          "b": g.normal(size=(r, N)).astype(np.float32)}}}


def _delta(rnd, cid, r=R):
    return {"blk": {"q": {k: torch.from_numpy(v) for k, v in
                          _np_delta(rnd, cid, r)["blk"]["q"].items()}}}


def _bitwise(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _boot(fed_cfg, serve_cfg=None, params=None, template=None):
    srv = FederationServer(_params() if params is None else params,
                           _template() if template is None else template,
                           scale=0.5, fed_cfg=fed_cfg,
                           serve_cfg=serve_cfg or ServeConfig(port=0))
    httpd = start_http_server(srv, port=0)
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def served():
    """A 3-client 2-round port server with token auth and obs trace."""
    srv, httpd, url = _boot(FedConfig(num_clients=3, rounds=2, obs="trace"),
                            ServeConfig(port=0, token="tok",
                                        quota_per_round=2))
    yield srv, url
    _stop(httpd)


def _client(url, cid, **kw):
    return FedClient(url, cid, device="cpu", **kw)


def _twin(rounds, delivered, weights=None, *, hetero=False):
    """The in-process twin: an engine of its own (its own params) fed the
    same deltas round by round. Returns (global, params or client params,
    engine)."""
    kw = dict(method="hetero", client_ranks=list(HET_RANKS)) if hetero else {}
    eng = RoundCloseEngine(_params(), _template(), c_max=3, scale=0.5, **kw)
    bases = [_params() for _ in range(3)] if hetero else _params()
    glob = None
    for rnd in range(rounds):
        eng.buffers.begin_round({i: i for i in range(3)}, round_id=rnd)
        for i in delivered[rnd]:
            if hetero:
                eng.buffers.write(i, pad_adapters(_delta(rnd, i,
                                                         HET_RANKS[i]), R),
                                  round_id=rnd, rank=HET_RANKS[i])
            else:
                eng.buffers.write(i, _delta(rnd, i), round_id=rnd)
        if hetero:
            new_cp, _, glob, div = eng.close_hetero(
                bases, list(delivered[rnd]), weights, round_id=rnd)
            for i, p in new_cp.items():
                bases[i] = p
        else:
            glob, bases, div = eng.close(bases, list(delivered[rnd]),
                                         weights, round_id=rnd)
        div.resolve()
    return glob, bases, eng


# --------------------------------------------------------------------------
# wire frames
# --------------------------------------------------------------------------

CODEC_CASES = [("none", R, None), ("fp16", R, None), ("int8", R, None),
               ("none", 1, 1)]
CODEC_IDS = ["none", "fp16", "int8", "ragged"]


@pytest.mark.parametrize("codec,r,rank", CODEC_CASES, ids=CODEC_IDS)
def test_frames_byte_identical_to_reference(codec, r, rank):
    ref = jax_to_wire(JCodec(codec).encode(_np_delta(0, 1, r), round_id=3,
                                           client_id=1, rank=rank))
    port = payload_to_wire(AdapterCodec(codec).encode(
        _delta(0, 1, r), round_id=3, client_id=1, rank=rank))
    assert port == ref
    assert (b'"rank"' in port) == (rank is not None)


@pytest.mark.parametrize("codec,r,rank", CODEC_CASES, ids=CODEC_IDS)
def test_each_package_parses_the_others_frames(codec, r, rank):
    pc, jc = AdapterCodec(codec), JCodec(codec)
    mine = pc.encode(_delta(0, 2, r), round_id=1, client_id=2, rank=rank)
    theirs = jc.encode(_np_delta(0, 2, r), round_id=1, client_id=2,
                       rank=rank)
    got = payload_from_wire(jax_to_wire(theirs))
    assert ((got.round_id, got.client_id, got.codec, got.rank)
            == (1, 2, codec, rank))
    _bitwise(pc.decode(got), pc.decode(mine))
    back = jax_from_wire(payload_to_wire(mine))
    want = flatten_with_paths(jc.decode(theirs))
    for k, x in flatten_with_paths(jc.decode(back)).items():
        np.testing.assert_array_equal(np.asarray(x), np.asarray(want[k]))


@pytest.mark.parametrize("mangle", [
    lambda b: b"XXXX" + b[4:],                      # magic
    lambda b: b[:6],                                # truncated header
    lambda b: b[:-3],                               # truncated body
    lambda b: b + b"\x00\x00",                      # trailing garbage
    lambda b: b[:4] + b"\xff\xff\xff\xff" + b[8:],  # absurd header length
    lambda b: b.replace(b"float32", b"float64", 1),  # unknown dtype
], ids=["magic", "header", "body", "trailing", "hlen", "dtype"])
def test_malformed_frames_raise_wire_reason(mangle):
    blob = payload_to_wire(AdapterCodec("none").encode(
        _delta(0, 0), round_id=0, client_id=0))
    with pytest.raises(TransportError) as ei:
        payload_from_wire(mangle(blob))
    assert ei.value.reason == "wire"


def test_declared_shape_survives_framing():
    """A truncated buffer still declares its full shape across the wire,
    and the decode quarantines it (reason ``bytes``)."""
    c = AdapterCodec("none")
    payload = c.encode(_delta(0, 0), round_id=0, client_id=0)
    path, enc = next(iter(payload.tensors.items()))
    cut = type(enc)(enc.data.reshape(-1)[:-2], enc.scale,
                    tuple(enc.data.shape))
    bad = Payload(payload.round_id, payload.client_id, payload.direction,
                  payload.codec, {**payload.tensors, path: cut})
    with pytest.raises(TransportError) as ei:
        c.decode(payload_from_wire(payload_to_wire(bad)))
    assert ei.value.reason == "bytes"


# --------------------------------------------------------------------------
# the service on the port, against its in-process twin
# --------------------------------------------------------------------------

def test_rounds_close_bitwise_vs_inprocess_twin(served):
    srv, url = served
    clients = [_client(url, i, token="tok") for i in range(3)]
    for rnd in range(2):
        for i, c in enumerate(clients):
            assert c.submit_delta(_delta(rnd, i),
                                  round_id=rnd)["status"] == "accepted"
    pull = clients[0].pull_latest()
    assert pull.version == 2
    glob, params, eng = _twin(2, [(0, 1, 2)] * 2)
    _bitwise(pull.lora, glob)
    assert pull.w0_digest == w0_digest(eng.specs, params)
    assert clients[0].health()["status"] == "done"
    with pytest.raises(StaleUplinkError):  # 410
        clients[0].submit_delta(_delta(5, 0), round_id=5)
    srv.finalize()
    recs = srv.rec.round_records()
    assert [r["delivered"] for r in recs] == [3, 3]
    assert all("close_block_us" in r and "divergence" in r for r in recs)


def test_examples_weighting_matches_weighted_twin():
    srv, httpd, url = _boot(FedConfig(num_clients=3, rounds=1,
                                      weighting="examples"))
    ns = [120, 40, 200]
    try:
        for i in range(3):
            _client(url, i, num_examples=ns[i]).submit_delta(_delta(0, i),
                                                             round_id=0)
        pull = _client(url, 0).pull_latest()
    finally:
        _stop(httpd)
    glob, params, eng = _twin(1, [(0, 1, 2)], [n / sum(ns) for n in ns])
    _bitwise(pull.lora, glob)
    assert pull.w0_digest == w0_digest(eng.specs, params)


def test_wall_deadline_closes_at_quorum_without_posts():
    srv, httpd, url = _boot(FedConfig(num_clients=3, rounds=1, min_quorum=2,
                                      round_deadline=0.3))
    try:
        for i in (0, 2):
            _client(url, i).submit_delta(_delta(0, i), round_id=0)
        assert srv.version == 0  # the quorum is met, the deadline not
        end = time.monotonic() + 5.0
        while srv.version == 0 and time.monotonic() < end:
            srv.tick()
            time.sleep(0.02)
        assert srv.version == 1 and srv.done
        pull = _client(url, 0).pull_latest()
    finally:
        _stop(httpd)
    glob, params, eng = _twin(1, [(0, 2)])
    _bitwise(pull.lora, glob)
    assert pull.w0_digest == w0_digest(eng.specs, params)


def test_hetero_rounds_close_bitwise_and_wrong_rank_is_quarantined():
    srv, httpd, url = _boot(FedConfig(num_clients=3, rounds=2, obs="trace",
                                      method="hetero",
                                      client_ranks=HET_RANKS))
    try:
        c0 = _client(url, 0)
        with pytest.raises(TransportError) as ei:  # rank beyond r_max
            c0.submit_delta(_delta(0, 0), round_id=0, rank=R + 3)
        assert ei.value.reason == "rank"
        with pytest.raises(TransportError) as ei:  # width ≠ declaration
            c0.submit_delta(_delta(0, 0, R + 1), round_id=0, rank=1)
        assert ei.value.reason == "rank"
        counters = srv.rec.metrics.snapshot()["counters"]
        assert counters["uplink.quarantined[rank]"] == 2
        for rnd in range(2):
            for i in range(3):
                _client(url, i).submit_delta(_delta(rnd, i, HET_RANKS[i]),
                                             round_id=rnd, rank=HET_RANKS[i])
        pull = c0.pull_latest()
    finally:
        _stop(httpd)
    assert pull.version == 2
    glob, bases, eng = _twin(2, [(0, 1, 2)] * 2, hetero=True)
    _bitwise(pull.lora, glob)
    assert pull.w0_digest == hetero_w0_digest(eng.specs, bases)
    for i in range(3):
        assert srv.client_loras[i]["blk"]["q"]["a"].shape == (M, HET_RANKS[i])
    # every client's base is its own tensor
    ptrs = {id(p["blk"]["q"]["kernel"]) for p in srv.client_params}
    assert len(ptrs) == 3


def test_statuses(served):
    srv, url = served
    with pytest.raises(TransportError) as ei:  # 401
        _client(url, 0, token="wrong").submit_delta(_delta(0, 0), round_id=0)
    assert ei.value.reason == "auth"
    with pytest.raises(TransportError) as ei:  # 403
        _client(url, 99, token="tok").submit_delta(_delta(0, 9), round_id=0)
    assert ei.value.reason == "unknown_client"
    req = urllib.request.Request(f"{url}/v1/rounds/0/deltas",
                                 data=b"not a frame", method="POST",
                                 headers={"Authorization": "Bearer tok"})
    with pytest.raises(urllib.error.HTTPError) as he:  # 400
        urllib.request.urlopen(req)
    assert he.value.code == 400
    bad = _delta(0, 1)
    bad["blk"]["q"]["a"][0, 0] = float("nan")
    with pytest.raises(TransportError) as ei:  # 422
        _client(url, 1, token="tok").submit_delta(bad, round_id=0)
    assert ei.value.reason == "nonfinite"
    c0 = _client(url, 0, token="tok", retries=1, backoff=0.01)
    c0.submit_delta(_delta(0, 0), round_id=0)
    with pytest.raises(StaleUplinkError):  # 409: the duplicate lane
        c0.submit_delta(_delta(0, 0), round_id=0)
    with pytest.raises(TransportError) as ei:  # 429 until the budget dies
        c0.submit_delta(_delta(0, 0), round_id=0)
    assert ei.value.reason == "retries_exhausted"
    for i in (1, 2):
        _client(url, i, token="tok").submit_delta(_delta(0, i), round_id=0)
    with pytest.raises(StaleUplinkError):  # 409: round 0 closed (replay)
        _client(url, 2, token="tok").submit_delta(_delta(0, 2), round_id=0)
    counters = srv.rec.metrics.snapshot()["counters"]
    assert counters["uplink.http_rejected[auth]"] == 1
    assert counters["uplink.http_rejected[quota]"] == 2
    assert counters["uplink.quarantined[nonfinite]"] == 1
    tot = srv.ledger.round_totals(0)
    assert tot["quarantined_bytes"] > 0 and tot["dropped_bytes"] > 0


def test_http_bytes_reconcile_with_payload_plus_overhead(served):
    srv, url = served
    bad = _delta(0, 1)
    bad["blk"]["q"]["b"][0, 0] = float("inf")
    c0, c1 = (_client(url, i, token="tok") for i in (0, 1))
    c0.submit_delta(_delta(0, 0), round_id=0)
    with pytest.raises(StaleUplinkError):
        c0.submit_delta(_delta(0, 0), round_id=0)
    with pytest.raises(TransportError):
        c1.submit_delta(bad, round_id=0)
    c0.pull_latest()
    counters = srv.rec.metrics.snapshot()["counters"]
    tot = srv.ledger.round_totals(0)
    payload_bytes = (tot["uplink_bytes"] + tot["quarantined_bytes"]
                     + tot["dropped_bytes"])
    down = srv.ledger.entries[-2:]  # the pull's payload and its frame
    frame = sum(e.nbytes for e in down if e.direction == "http_overhead")
    assert tot["http_overhead_params"] == 0
    assert (counters["uplink.http_overhead_bytes"]
            == tot["http_overhead_bytes"] - frame)
    assert counters["uplink.http_bytes"] == (
        payload_bytes + counters["uplink.http_overhead_bytes"])
    assert counters["downlink.http_bytes"] == tot["downlink_bytes"] + frame


def test_simclock_wall_mode():
    c = SimClock()
    c.advance(0.1)
    c.advance_to(1.5)
    assert c.now() == 1.5 and c.state_dict() == {"t": 1.5}
    fake = [100.0]
    w = SimClock(now_fn=lambda: fake[0])
    assert w.now() == 0.0
    fake[0] = 100.5
    assert w.now() == pytest.approx(0.5)
    w.advance(2.0)          # a floor: at least 2 s later
    fake[0] = 101.0         # the wall behind the floor
    assert w.now() == pytest.approx(2.5)
    fake[0] = 104.0
    assert w.now() == pytest.approx(4.0)
    state = w.state_dict()
    w2 = SimClock(now_fn=lambda: fake[0])
    w2.load_state(state)    # the restored value is the new origin
    fake[0] = 105.5
    assert w2.now() == pytest.approx(5.5)


# --------------------------------------------------------------------------
# across frameworks, and each package's client against the other's server
# --------------------------------------------------------------------------

def test_servers_agree_across_frameworks():
    port, phttpd, purl = _boot(FedConfig(num_clients=3, rounds=2,
                                         obs="trace"))
    ref = JServer({"blk": {"q": {"kernel": jnp.asarray(
                      _np_params()["blk"]["q"]["kernel"])}}},
                  {"blk": {"q": {"a": jnp.zeros((M, R)),
                                 "b": jnp.zeros((R, N))}}},
                  scale=0.5, fed_cfg=JFedConfig(num_clients=3, rounds=2,
                                                obs="trace", engine="jnp"))
    jhttpd = jax_start_http_server(ref, port=0)
    jurl = f"http://127.0.0.1:{jhttpd.server_address[1]}"
    nan = _np_delta(0, 1)
    nan["blk"]["q"]["a"][0, 0] = np.nan
    # (round, client, delta): a quarantine and a duplicate included
    posts = [(0, 1, nan), (0, 0, _np_delta(0, 0)), (0, 0, _np_delta(0, 0)),
             (0, 1, _np_delta(0, 1)), (0, 2, _np_delta(0, 2))]
    posts += [(1, i, _np_delta(1, i)) for i in (2, 0, 1)]
    statuses = []
    try:
        for rnd, cid, d in posts:
            got = []
            # the reference's client → the port's server, and the port's
            # client → the reference's server
            for call in (lambda: JFedClient(purl, cid).submit_delta(
                             d, round_id=rnd),
                         lambda: _client(jurl, cid).submit_delta(
                             {"blk": {"q": {k: torch.from_numpy(v) for k, v
                                            in d["blk"]["q"].items()}}},
                             round_id=rnd)):
                try:
                    got.append(("ok", call()["version"]))
                except TransportError as e:
                    got.append((type(e).__name__, e.reason))
                except Exception as e:  # the reference's error types
                    got.append((type(e).__name__, getattr(e, "reason", "")))
            statuses.append(got)
        ppull = _client(purl, 0).pull_latest()
        jpull = JFedClient(jurl, 0).pull_latest()
    finally:
        _stop(phttpd)
        jax_server_stop(jhttpd)
    for a, b in statuses:
        assert a == b
    assert [s[0][0] for s in statuses] == (
        ["TransportError", "ok", "StaleUplinkError", "ok", "ok"]
        + ["ok"] * 3)
    assert ppull.version == jpull.version == 2
    strip = {"http_overhead_params", "http_overhead_bytes"}
    ptot = {k: v for k, v in port.ledger.totals().items() if k not in strip}
    jtot = {k: v for k, v in ref.ledger.totals().items() if k not in strip}
    assert ptot == jtot
    want = flatten_with_paths(jpull.lora)
    for k, x in flatten_with_paths(ppull.lora).items():
        np.testing.assert_allclose(x.numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        port.params["blk"]["q"]["kernel"].numpy(),
        np.asarray(ref.params["blk"]["q"]["kernel"]), rtol=1e-5, atol=1e-6)


def jax_server_stop(httpd):
    httpd.shutdown()
    httpd.server_close()


# --------------------------------------------------------------------------
# concurrent ingest into the port's ring
# --------------------------------------------------------------------------

def _run_threads(fns):
    """Start every thunk behind one barrier, so that they contend."""
    barrier = threading.Barrier(len(fns))
    errors = []

    def wrap(fn):
        try:
            barrier.wait()
            fn()
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "writer thread wedged"
    assert not errors, errors


def test_threaded_writes_land_exactly_once():
    c, dup = 12, 3
    buf = RoundBuffers(_template(), c_max=c)
    buf.begin_round({i: i for i in range(c)}, round_id=0)
    wins = []
    lock = threading.Lock()

    def writer(cid):
        def go():
            ok = buf.write(cid, _delta(0, cid), round_id=0)
            with lock:
                wins.append((cid, ok))
        return go

    _run_threads([writer(i) for i in range(c) for _ in range(dup)])
    for cid in range(c):
        assert sum(ok for x, ok in wins if x == cid) == 1
    assert buf.duplicate_drops == c * (dup - 1)
    stacks = buf.take(0)
    for path, stack in stacks.items():
        for i in range(c):
            assert torch.equal(stack[i], flatten_with_paths(
                _delta(0, i))[path]), (path, i)


def test_threaded_close_equals_serial_twin():
    c = 12
    threaded = RoundCloseEngine(_params(), _template(), c_max=c, scale=0.5)
    serial = RoundCloseEngine(_params(), _template(), c_max=c, scale=0.5)
    for eng in (threaded, serial):
        eng.buffers.begin_round({i: i for i in range(c)}, round_id=0)
    _run_threads([(lambda cid: lambda: threaded.buffers.write(
        cid, _delta(0, cid), round_id=0))(i) for i in reversed(range(c))])
    for i in range(c):
        serial.buffers.write(i, _delta(0, i), round_id=0)
    weights = [float(i + 1) for i in range(c)]
    weights = [w / sum(weights) for w in weights]
    lt, pt, _ = threaded.close(_params(), list(range(c)), weights,
                               round_id=0)
    ls, ps, _ = serial.close(_params(), list(range(c)), weights, round_id=0)
    _bitwise(lt, ls)
    _bitwise(pt, ps)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_concurrent_decode_into_lands_every_lane(quantize):
    c = 12
    codec = AdapterCodec(quantize, validation=ValidationPolicy())
    codec.register_spec(_template())
    buf = RoundBuffers(_template(), c_max=c)
    buf.begin_round({i: i for i in range(c)}, round_id=0)
    payloads = [codec.encode(_delta(0, i), round_id=0, client_id=i)
                for i in range(c)]
    stale = []
    lock = threading.Lock()

    def writer(p):
        def go():
            try:
                codec.decode_into(p, buf)
            except StaleUplinkError:
                with lock:
                    stale.append(p.client_id)
        return go

    _run_threads([writer(p) for p in payloads for _ in range(2)])
    assert sorted(stale) == list(range(c))
    assert codec._ingest_bytes == sum(p.nbytes for p in payloads)
    stacks = buf.take(0)
    for i, p in enumerate(payloads):
        want = flatten_with_paths(AdapterCodec(quantize).decode(p))
        for path, stack in stacks.items():
            assert torch.equal(stack[i], want[path]), (path, i, quantize)


# --------------------------------------------------------------------------
# serve --pull-from
# --------------------------------------------------------------------------

def test_serve_pull_from_equals_serving_the_twins_adapter():
    cfg = get_config("paper-tiny")
    lora_cfg = LoRAConfig(rank=4)
    model = build_model(cfg)
    params, glob = init_global_state(model, lora_cfg, seed=0, device=CPU)
    gen = torch.Generator().manual_seed(3)
    flat = flatten_with_paths(glob)
    deltas = [{p: torch.randn(x.shape, generator=gen) * 0.05
               for p, x in flat.items()} for _ in range(2)]
    srv, httpd, url = _boot(FedConfig(num_clients=2, rounds=1),
                            params=params, template=glob)
    try:
        for i, d in enumerate(deltas):
            _client(url, i).submit_delta(unflatten_from_paths(d),
                                         round_id=0)
        kw = dict(batch_size=2, prompt_len=16, steps=4, max_len=32, rank=4,
                  seed=0, device="cpu")
        pulled = serve("paper-tiny", pull_from=url, **kw)
    finally:
        _stop(httpd)
    tparams, tglob = init_global_state(model, lora_cfg, seed=0, device=CPU)
    twin = RoundCloseEngine(tparams, tglob, c_max=2, scale=lora_cfg.scale)
    twin.buffers.begin_round({0: 0, 1: 1}, round_id=0)
    for i, d in enumerate(deltas):
        twin.buffers.write_flat(i, d, round_id=0)
    tglob, _, _ = twin.close(tparams, [0, 1], round_id=0)
    direct = serve("paper-tiny", lora=tglob, **kw)
    np.testing.assert_array_equal(pulled.tokens, direct.tokens)
    assert pulled.tokens.shape == (2, 5)
