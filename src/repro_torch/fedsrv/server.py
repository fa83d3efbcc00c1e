"""HTTP federation service: the round coordinator behind a real socket.

The port's counterpart of ``repro/fedsrv/server.py``. Below the socket is
the port's own stack — the :class:`~repro_torch.fedsrv.transport.
AdapterCodec`'s defended decode straight into the
:class:`~repro_torch.core.engine.RoundCloseEngine`'s ring, its close, the
:class:`~repro_torch.fedsrv.transport.BytesLedger` and the obs recorder —
composed as the in-process coordinator composes them, so an HTTP round
closes bitwise like an in-process round over the same deliveries.

Endpoints:

* ``POST /v1/rounds/{round_id}/deltas`` — one wire-framed uplink
  (:mod:`repro_torch.fedsrv.wire`), answered with the reference's statuses:
  200 accepted (the lane written), 400 a malformed frame or a payload whose
  round is not the path's, 401 a bad or missing bearer token, 403 an
  unknown client, 409 a stale / replayed / duplicate lane, 410 every round
  served, 422 quarantined by validation (``uplink.quarantined[reason]``),
  429 the (client, round) quota or the decode slots exhausted (with
  ``Retry-After``).
* ``GET /v1/adapters/latest`` — the global adapter as a wire frame, with
  ``X-Fed-Version`` (closes so far), ``X-Fed-Round`` and ``X-Fed-W0-Digest``:
  sha256 over the adapted W0 leaves' float32 host bytes in spec order
  (:func:`w0_digest`; :func:`hetero_w0_digest` chains every client's), the
  residual fold's witness, cached per version.
* ``GET /v1/healthz`` — round / version / delivery progress (it also
  closes a round whose deadline passed with its quorum met).
* ``GET /v1/metrics`` — the ledger's totals, the recorder's snapshot and
  round records.

Concurrency: ``ThreadingHTTPServer`` handler threads decode and validate in
parallel (their device work goes to the current stream) and serialise only
at the ring's lock and the round bookkeeping (``self._lock``); the close
runs in the handler thread that completes a round, under ``self._lock``. A
bounded semaphore admits ``ServeConfig.max_concurrent`` decodes at once;
more POSTs get 429. Round N's divergence resolves at round N+1's close,
after round N+1's uplinks landed, as the trainer's does (the overlap
invariant).

Deadlines: the server's :class:`~repro_torch.fedsrv.registry.SimClock`
runs on ``time.monotonic``, so ``FedConfig.round_deadline`` means wall
seconds.

The server owns the ``params`` it is given: the kernel close folds into
their W0 leaves in place, so an in-process twin needs tensors of its own.
A hetero server gives every client its own copy of the adapted W0 leaves.
"""

from __future__ import annotations

import hashlib
import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import FedConfig, ServeConfig
from repro_torch.core.engine import (RoundCloseEngine, collect_w0_leaves,
                                     fold_back_w0)
from repro_torch.core.lora import init_global_state
from repro_torch.fedsrv.registry import SimClock
from repro_torch.fedsrv.transport import (AdapterCodec, BytesLedger,
                                          StaleUplinkError, TransportError,
                                          ValidationPolicy)
from repro_torch.fedsrv.wire import payload_from_wire, payload_to_wire
from repro_torch.obs import make_recorder
from repro_torch.util.tree import flatten_with_paths

logger = logging.getLogger("repro_torch.fedsrv.server")

_DELTAS_RE = re.compile(r"^/v1/rounds/(-?\d+)/deltas$")

__all__ = ["FederationHTTPServer", "FederationServer", "hetero_w0_digest",
           "init_global_state", "start_http_server", "w0_digest"]


def w0_digest(specs, params) -> str:
    """sha256 over the adapted W0 leaves in spec order, their float32 host
    bytes (copied one leading slice at a time)."""
    h = hashlib.sha256()
    leaves = collect_w0_leaves(specs, params)
    for s in specs:
        leaf = leaves[s.key].detach().float()
        for part in (leaf if leaf.ndim > 2 else [leaf]):
            h.update(part.contiguous().cpu().numpy())
    return h.hexdigest()


def hetero_w0_digest(specs, client_params) -> str:
    """sha256 chained over every client's :func:`w0_digest` in client-id
    order: a hetero close folds a different residual into each base."""
    h = hashlib.sha256()
    for p in client_params:
        h.update(bytes.fromhex(w0_digest(specs, p)))
    return h.hexdigest()


class FederationServer:
    """Round lifecycle and defended ingest behind the HTTP handler.

    The federation's semantics come from ``fed_cfg`` (clients, rounds,
    quorum, ``round_deadline`` in wall seconds, weighting, codec, engine
    backend); ``serve_cfg`` adds the socket surface. Rounds are numbered
    0..rounds−1, and every client 0..num_clients−1 has a lane in each.
    """

    def __init__(self, params, global_lora, *, scale: float,
                 fed_cfg: FedConfig, serve_cfg: Optional[ServeConfig] = None,
                 recorder=None):
        if fed_cfg.engine == "off":
            raise ValueError("--mode serve needs the streaming close engine "
                             "(engine=off is the eager list path)")
        if fed_cfg.method not in ("fedex", "fedex_svd", "hetero"):
            raise ValueError(f"serve mode closes fedex/fedex_svd/hetero "
                             f"rounds, got method={fed_cfg.method!r}")
        self.fed_cfg = fed_cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self.hetero = (fed_cfg.method == "hetero"
                       or bool(fed_cfg.client_ranks))
        self.client_ranks = list(fed_cfg.client_ranks) or None
        if self.hetero:
            eng_method = "hetero"
        elif fed_cfg.method == "fedex_svd" and fed_cfg.svd_rank:
            eng_method = "fedex_svd"
        else:
            eng_method = "fedex"
        self.device = next(iter(flatten_with_paths(global_lora).values())
                           ).device
        self.rec = (recorder if recorder is not None
                    else make_recorder(fed_cfg.obs, self.device))
        self.clock = SimClock(now_fn=time.monotonic)  # wall seconds
        self.codec = AdapterCodec(
            fed_cfg.quantize_uplink, recorder=self.rec,
            validation=ValidationPolicy(enabled=fed_cfg.uplink_validation,
                                        max_norm=fed_cfg.uplink_max_norm))
        self.codec.register_spec(global_lora)
        self.ledger = BytesLedger()
        self.engine = RoundCloseEngine(
            params, global_lora, c_max=fed_cfg.num_clients, scale=scale,
            method=eng_method, svd_rank=fed_cfg.svd_rank,
            backend=fed_cfg.engine, depth=fed_cfg.ring_depth,
            client_ranks=self.client_ranks if self.hetero else None,
            chunk=fed_cfg.close_chunk,
            recorder=self.rec if self.rec.enabled else None)
        self.params = params
        # hetero: one base per client, each with its own adapted W0 leaves
        # (the kernel close folds in place)
        self.client_params = None
        if self.hetero:
            specs = self.engine.specs
            self.client_params = [
                fold_back_w0(specs, params, {
                    k: x.clone() for k, x in
                    collect_w0_leaves(specs, params).items()})
                for _ in range(fed_cfg.num_clients)]
        self.client_loras: Dict[int, Any] = {}  # cid → rank-r_i adapters
        self.global_lora = global_lora
        self.version = 0            # closes so far
        self.round_id = 0
        self.done = False
        self._lock = threading.RLock()
        self._uplink_slots = threading.BoundedSemaphore(
            self.serve_cfg.max_concurrent)
        self._quota: Dict[Tuple[int, int], int] = {}  # (round, cid) → POSTs
        self._examples: Dict[int, float] = {}         # cid → declared n
        self._deadline_at: Optional[float] = None
        # the last close's divergence, resolved at the next close (after
        # that round's uplinks landed) or at finalize()
        self._pending_div = None
        self._digest_cache: Tuple[int, Optional[str]] = (-1, None)
        self.digest_s = 0.0  # host seconds of the last digest computed
        self._t_wall0 = time.monotonic()
        self._open_round(0)

    # -- round lifecycle (callers hold self._lock) --------------------------
    def _open_round(self, rid: int) -> None:
        slots = {cid: cid for cid in range(self.fed_cfg.num_clients)}
        ddl = None
        if self.fed_cfg.round_deadline > 0:
            ddl = self.clock.now() + self.fed_cfg.round_deadline
        self.engine.buffers.begin_round(slots, round_id=rid, deadline=ddl,
                                        now=self.clock.now())
        self.round_id = rid
        self._deadline_at = ddl
        logger.info("round %d open (C=%d, deadline=%s)", rid, len(slots),
                    "none" if ddl is None
                    else f"+{self.fed_cfg.round_deadline}s")

    def _resolve_pending(self) -> None:
        if self._pending_div is not None:
            self._pending_div.resolve()
            self._pending_div = None

    def _close_round(self, rid: int) -> None:
        delivered = sorted(self.engine.buffers.delivered_in(rid))
        weights = None
        if self.fed_cfg.weighting == "examples":
            ns = [self._examples.get(c, 1.0) for c in delivered]
            weights = [n / sum(ns) for n in ns]
        # round N−1's host sync happens here, after round N's writes
        self._resolve_pending()
        if self.hetero:
            new_cp, new_loras, self.global_lora, div = \
                self.engine.close_hetero(self.client_params, delivered,
                                         weights, round_id=rid)
            for cid, p in new_cp.items():
                self.client_params[cid] = p
            self.client_loras.update(new_loras)
            self.params = self.client_params[0]
        else:
            self.global_lora, self.params, div = self.engine.close(
                self.params, delivered, weights, round_id=rid)
        self._pending_div = div
        self.version += 1
        if self.rec.enabled:
            self.rec.round_set(rid, delivered=len(delivered),
                               sampled=self.fed_cfg.num_clients)
            self._stamp_round_comm(rid)
            self.rec.event("round.close", cat="server", round=rid,
                           delivered=len(delivered), version=self.version)
        logger.info("round %d closed: %d/%d delivered, version=%d", rid,
                    len(delivered), self.fed_cfg.num_clients, self.version)
        if self.version >= self.fed_cfg.rounds:
            self.done = True
            self._resolve_pending()  # no further writes are coming
        else:
            self._open_round(rid + 1)

    def _maybe_close(self) -> bool:
        """Close the current round when every lane delivered, or when its
        deadline passed with the quorum met. Caller holds ``self._lock``."""
        if self.done:
            return False
        rid = self.round_id
        delivered = self.engine.buffers.delivered_in(rid)
        if len(delivered) >= self.fed_cfg.num_clients:
            self._close_round(rid)
            return True
        if (self._deadline_at is not None
                and self.clock.now() >= self._deadline_at
                and len(delivered) >= max(1, self.fed_cfg.min_quorum)):
            self._close_round(rid)
            return True
        return False

    def tick(self) -> None:
        """Deadline poll: a quorum round closes with no new POST."""
        with self._lock:
            self._maybe_close()

    def finalize(self) -> None:
        """Resolve the last divergence (waits for the device), so every
        closed round record carries its block time and divergence."""
        with self._lock:
            self._resolve_pending()

    # -- accounting ---------------------------------------------------------
    def _stamp_round_comm(self, rid: int) -> None:
        """The ledger's totals of round ``rid`` on its record (again when an
        uplink is accounted after its round closed)."""
        tot = self.ledger.round_totals(rid)
        self.rec.round_set(rid,
                           uplink_bytes=tot["uplink_bytes"],
                           uplink_params=tot["uplink_params"],
                           downlink_bytes=tot["downlink_bytes"],
                           downlink_params=tot["downlink_params"])

    def _account(self, payload, body_len: int, header_len: int,
                 direction: str, note: str) -> None:
        """Ledger the payload under ``direction`` (uplink / quarantined /
        dropped) and the HTTP request line, headers and frame envelope
        under ``http_overhead`` (socket bytes, zero params)."""
        overhead = (body_len - payload.nbytes) + header_len
        self.ledger.record(payload, note=note, direction=direction)
        self.ledger.record_raw(payload.round_id, "http_overhead", overhead,
                               client_id=payload.client_id,
                               note="frame+headers")
        if self.rec.enabled:
            self.rec.counter("uplink.http_requests").inc()
            self.rec.counter("uplink.http_bytes").inc(body_len + header_len)
            self.rec.counter("uplink.http_overhead_bytes").inc(overhead)
            if payload.round_id < self.round_id or self.done:
                self._stamp_round_comm(payload.round_id)  # late account

    # -- request handlers ---------------------------------------------------
    def handle_submit(self, path_round: int, body, header_len: int,
                      token: Optional[str], examples: Optional[float]
                      ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """One uplink POST → (status, JSON body, extra headers)."""
        rec, cfg = self.rec, self.serve_cfg
        if cfg.token and token != cfg.token:
            if rec.enabled:
                rec.counter("uplink.http_rejected[auth]").inc()
            return 401, {"error": "auth",
                         "detail": "missing or bad bearer token"}, {}
        try:
            payload = payload_from_wire(body, device=self.device)
        except TransportError as e:
            if rec.enabled:
                rec.counter("uplink.http_rejected[wire]").inc()
            return 400, {"error": "wire", "detail": str(e)}, {}
        cid = payload.client_id
        if not 0 <= cid < self.fed_cfg.num_clients:
            if rec.enabled:
                rec.counter("uplink.http_rejected[unknown_client]").inc()
            return 403, {"error": "unknown_client", "client": cid}, {}
        if payload.round_id != path_round:
            if rec.enabled:
                rec.counter("uplink.http_rejected[wire]").inc()
            return 400, {"error": "wire",
                         "detail": f"payload round {payload.round_id} != "
                                   f"path round {path_round}"}, {}
        with self._lock:
            if self.done:
                return 410, {"error": "done",
                             "detail": "all rounds served"}, {}
            self._maybe_close()  # a passed deadline closes first
            q = self._quota.get((path_round, cid), 0)
            if q >= cfg.quota_per_round:
                if rec.enabled:
                    rec.counter("uplink.http_rejected[quota]").inc()
                return 429, {"error": "quota",
                             "detail": f"{q} POSTs for (round {path_round}, "
                                       f"client {cid})"}, \
                    {"Retry-After": "1"}
            self._quota[(path_round, cid)] = q + 1
            if examples is not None:
                self._examples[cid] = float(examples)
        # backpressure: bounded concurrent decodes, never a blocked handler
        if not self._uplink_slots.acquire(blocking=False):
            if rec.enabled:
                rec.counter("uplink.http_rejected[busy]").inc()
            return 429, {"error": "busy",
                         "detail": "uplink decode slots exhausted"}, \
                {"Retry-After": "0.1"}
        try:
            weight = None
            if self.fed_cfg.weighting == "examples" and examples is not None:
                weight = float(examples)
            # decode and validation run concurrently across handler
            # threads; only the lane copy serialises (the ring's lock)
            self.codec.decode_into(payload, self.engine.buffers,
                                   weight=weight)
        except StaleUplinkError as e:
            with self._lock:
                self._account(payload, len(body), header_len, "dropped",
                              f"drop:{e.reason}")
            return 409, {"error": "stale", "reason": e.reason}, {}
        except TransportError as e:
            with self._lock:
                self._account(payload, len(body), header_len, "quarantined",
                              f"quarantine:{e.reason}")
                if rec.enabled:
                    rec.counter(f"uplink.quarantined[{e.reason}]").inc()
            return 422, {"error": "quarantined", "reason": e.reason}, {}
        finally:
            self._uplink_slots.release()
        with self._lock:
            self._account(payload, len(body), header_len, "uplink",
                          "http uplink")
            delivered = (len(self.engine.buffers.delivered_in(path_round))
                         if path_round == self.round_id and not self.done
                         else None)
            closed = self._maybe_close()
            return 200, {"status": "accepted", "round": path_round,
                         "delivered": delivered, "closed": closed,
                         "version": self.version}, {}

    def handle_latest(self) -> Tuple[int, bytes, Dict[str, str]]:
        with self._lock:
            version, tree, rid = self.version, self.global_lora, self.round_id
            digest = self._current_digest()
        payload = self.codec.encode(tree, round_id=version, client_id=-1,
                                    direction="downlink")
        body = payload_to_wire(payload)
        with self._lock:
            self.ledger.record(payload, note="pull_latest")
            self.ledger.record_raw(version, "http_overhead",
                                   len(body) - payload.nbytes,
                                   note="frame (downlink)")
            if self.rec.enabled:
                self.rec.counter("downlink.http_requests").inc()
                self.rec.counter("downlink.http_bytes").inc(len(body))
        return 200, body, {"X-Fed-Version": str(version),
                           "X-Fed-Round": str(rid),
                           "X-Fed-W0-Digest": digest}

    def _current_digest(self) -> str:
        ver, cached = self._digest_cache
        if ver != self.version or cached is None:
            t0 = time.perf_counter()
            cached = (hetero_w0_digest(self.engine.specs, self.client_params)
                      if self.hetero
                      else w0_digest(self.engine.specs, self.params))
            self.digest_s = time.perf_counter() - t0
            self._digest_cache = (self.version, cached)
        return cached

    def handle_healthz(self) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            self._maybe_close()
            delivered = None
            if not self.done:
                delivered = len(
                    self.engine.buffers.delivered_in(self.round_id))
            return 200, {
                "status": "done" if self.done else "serving",
                "round": self.round_id,
                "version": self.version,
                "rounds": self.fed_cfg.rounds,
                "delivered": delivered,
                "expected": self.fed_cfg.num_clients,
                "uptime_s": round(time.monotonic() - self._t_wall0, 3),
            }

    def handle_metrics(self) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            out: Dict[str, Any] = {
                "ledger": self.ledger.totals(),
                "version": self.version,
                "rounds_closed": self.version,
            }
            if self.rec.enabled:
                out.update(self.rec.metrics.snapshot(),
                           rounds=self.rec.round_records())
            return 200, out


class FederationHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    timeout = 30  # a wedged client socket must not hold a thread forever

    def __init__(self, addr, fed: FederationServer):
        self.fed = fed
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    server_version = "fedsrv/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(code, json.dumps(obj).encode("utf-8"),
                   "application/json", headers)

    def _header_len(self) -> int:
        # the request line and the raw header block: the http_overhead
        # ledger direction and the uplink.http_* counters
        return len(self.requestline) + 2 + len(bytes(self.headers))

    def _token(self) -> Optional[str]:
        auth = self.headers.get("Authorization", "")
        return auth[len("Bearer "):] if auth.startswith("Bearer ") else None

    def _body(self) -> bytearray:
        """The request body, read into one ``bytearray`` (the wire parser
        views its tensors in place)."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = bytearray(length)
        view, got = memoryview(body), 0
        while got < length:
            n = self.rfile.readinto(view[got:])
            if not n:
                break
            got += n
        return body[:got] if got < length else body

    def do_GET(self):
        fed = self.server.fed
        with fed.rec.span("http.request", cat="http", method="GET",
                          path=self.path):
            if self.path == "/v1/healthz":
                self._send_json(*fed.handle_healthz())
            elif self.path == "/v1/metrics":
                self._send_json(*fed.handle_metrics())
            elif self.path == "/v1/adapters/latest":
                code, body, headers = fed.handle_latest()
                self._send(code, body, "application/octet-stream", headers)
            else:
                self._send_json(404, {"error": "not_found",
                                      "path": self.path})

    def do_POST(self):
        fed = self.server.fed
        m = _DELTAS_RE.match(self.path)
        with fed.rec.span("http.request", cat="http", method="POST",
                          path=self.path):
            if m is None:
                self._send_json(404, {"error": "not_found",
                                      "path": self.path})
                return
            body = self._body()
            examples = self.headers.get("X-Fed-Examples")
            code, obj, headers = fed.handle_submit(
                int(m.group(1)), body, self._header_len(),
                token=self._token(),
                examples=float(examples) if examples else None)
            self._send_json(code, obj, headers)


def start_http_server(fed: FederationServer, host: str = "127.0.0.1",
                      port: int = 0) -> FederationHTTPServer:
    """Bind and serve on a daemon thread; returns the bound server (its
    ``server_address[1]`` is the port — pass 0 for an ephemeral one). Call
    ``shutdown()`` and ``server_close()`` on it to stop."""
    httpd = FederationHTTPServer((host, port), fed)
    t = threading.Thread(target=httpd.serve_forever, name="fedsrv-http",
                         daemon=True)
    t.start()
    logger.info("fedsrv listening on http://%s:%d", *httpd.server_address)
    return httpd
