"""HTTP federation client: ``submit_delta`` / ``pull_latest`` over a socket.

The port's counterpart of ``repro/fedsrv/client.py``: encode with the same
:class:`~repro_torch.fedsrv.transport.AdapterCodec` the in-process
coordinator uses (on the adapter's device), frame with
:mod:`repro_torch.fedsrv.wire` (one copy to the host), POST, and map the
HTTP statuses back onto the transport's errors: 429 / 503 and connection
failures go through a bounded exponential-backoff retry loop
(``backoff · 2^attempt`` seconds of ``time.sleep``, ``retries``
re-attempts), 409 / 410 raise :class:`StaleUplinkError`, other rejections
:class:`TransportError` with the server's reason. A pulled adapter is
decoded through the defended codec onto ``device``.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.fedsrv.transport import (AdapterCodec, StaleUplinkError,
                                          TransientTransportError,
                                          TransportError)
from repro_torch.fedsrv.wire import payload_from_wire, payload_to_wire
from repro_torch.obs import NULL
from repro_torch.util.device import resolve_device

logger = logging.getLogger("repro_torch.fedsrv.client")

#: statuses worth a bounded retry (server backpressure, transient fabric)
_RETRYABLE = frozenset({429, 503})


@dataclass(frozen=True)
class PullResult:
    """One ``GET /v1/adapters/latest`` response."""

    version: int            # closes the server has performed
    round_id: int           # the round open on the server
    lora: Any               # the decoded global adapter tree
    w0_digest: str          # sha256 over the server's folded W0 leaves
    nbytes: int             # the frame's size


class FedClient:
    """One federated client talking to a
    :class:`~repro_torch.fedsrv.server.FederationServer`.

    ``quantize`` must match the server's ``FedConfig.quantize_uplink``;
    ``num_examples`` rides in the ``X-Fed-Examples`` header (it matters
    under example weighting). A pulled adapter lands on ``device``.
    """

    def __init__(self, base_url: str, client_id: int, *, token: str = "",
                 quantize: str = "none", num_examples: Optional[int] = None,
                 retries: int = 3, backoff: float = 0.1,
                 timeout: float = 30.0, recorder=None, device="cuda"):
        self.base_url = base_url.rstrip("/")
        self.client_id = client_id
        self.token = token
        self.codec = AdapterCodec(quantize, recorder=recorder)
        self.num_examples = num_examples
        self.retries = retries
        self.backoff = backoff
        self.timeout = timeout
        self.rec = recorder if recorder is not None else NULL
        self.device = resolve_device(device)

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        hdrs = dict(headers or {})
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(self.base_url + path, data=body,
                                     headers=hdrs, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            # a non-2xx status with a response: the status is the answer
            return e.code, e.read(), dict(e.headers or {})
        except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
            raise TransientTransportError(
                f"{method} {path}: {e}", client_id=self.client_id,
                reason="connect") from e

    @staticmethod
    def _json(data: bytes) -> Dict[str, Any]:
        try:
            return json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return {}

    def health(self) -> Dict[str, Any]:
        code, data, _ = self._request("GET", "/v1/healthz")
        if code != 200:
            raise TransientTransportError(f"healthz returned {code}",
                                          client_id=self.client_id,
                                          reason="health")
        return self._json(data)

    def current_round(self) -> int:
        return int(self.health()["round"])

    def metrics(self) -> Dict[str, Any]:
        return self._json(self._request("GET", "/v1/metrics")[1])

    def submit_delta(self, lora: Any, round_id: Optional[int] = None,
                     rank: Optional[int] = None) -> Dict[str, Any]:
        """Encode, frame and POST one adapter delta (its current round when
        ``round_id`` is None), with bounded-backoff retries on 429 / 503 /
        connection faults. ``rank`` declares a ragged (hetero) uplink's
        rank: its factors travel at their true width, and the server pads
        them to r_max."""
        rid = self.current_round() if round_id is None else int(round_id)
        payload = self.codec.encode(lora, round_id=rid,
                                    client_id=self.client_id,
                                    direction="uplink", rank=rank)
        body = payload_to_wire(payload)
        headers = {"Content-Type": "application/octet-stream"}
        if self.num_examples is not None:
            headers["X-Fed-Examples"] = str(self.num_examples)
        attempt = 0
        while True:
            try:
                code, data, _ = self._request(
                    "POST", f"/v1/rounds/{rid}/deltas", body, headers)
            except TransientTransportError:
                if attempt >= self.retries:
                    raise
                code = None
            if code == 200:
                return self._json(data)
            if code is not None and code not in _RETRYABLE:
                obj = self._json(data)
                reason = str(obj.get("reason", obj.get("error", "rejected")))
                err = (StaleUplinkError if code in (409, 410)
                       else TransportError)
                raise err(f"POST /v1/rounds/{rid}/deltas → {code}: "
                          f"{obj.get('detail', reason)}",
                          round_id=rid, client_id=self.client_id,
                          reason=reason)
            if code is not None and attempt >= self.retries:
                raise TransportError(
                    f"retry budget exhausted after {attempt + 1} POSTs "
                    f"(last status {code})", round_id=rid,
                    client_id=self.client_id, reason="retries_exhausted")
            delay = self.backoff * (2 ** attempt)
            if self.rec.enabled:
                self.rec.counter("uplink.http_retries").inc()
            logger.debug("client %d: POST retry %d in %.3fs (status=%s)",
                         self.client_id, attempt + 1, delay, code)
            time.sleep(delay)
            attempt += 1

    def pull_latest(self) -> PullResult:
        """GET the global adapter and decode it through the defended codec
        (a corrupt downlink is quarantined here)."""
        code, data, headers = self._request("GET", "/v1/adapters/latest")
        if code != 200:
            raise TransportError(f"pull_latest → {code}",
                                 client_id=self.client_id, reason="pull")
        payload = payload_from_wire(bytearray(data), device=self.device)
        return PullResult(
            version=int(headers.get("X-Fed-Version", -1)),
            round_id=int(headers.get("X-Fed-Round", -1)),
            lora=self.codec.decode(payload),
            w0_digest=headers.get("X-Fed-W0-Digest", ""),
            nbytes=len(data))
