"""Federation orchestration of the port: client registry, sampling, the
synchronous and FedBuff coordinators, the uplink transport, seeded fault
injection, and the HTTP federation service (server, client and wire
framing), each recording through :mod:`repro_torch.obs` (the counterpart of
``repro/fedsrv``)."""

from repro_torch.fedsrv.coordinator import (AsyncBufferCoordinator, Delivery,
                                            RoundCoordinator, RoundOutcome,
                                            RoundPolicy, UplinkResult)
from repro_torch.fedsrv.faults import (FAULT_KINDS, FaultInjector, FaultPlan,
                                       FaultSpec)
from repro_torch.fedsrv.registry import (DROPOUT_STREAM, FAULT_STREAM,
                                         ClientInfo, ClientRegistry, SimClock,
                                         StragglerModel, purpose_rng)
from repro_torch.fedsrv.transport import (CODECS, AdapterCodec, BytesLedger,
                                          EncodedTensor, LedgerEntry, Payload,
                                          StaleUplinkError,
                                          TransientTransportError,
                                          TransportError, ValidationPolicy)
# the service last: it imports the engine, whose package imports the
# trainer, which imports the names above
from repro_torch.fedsrv.wire import payload_from_wire, payload_to_wire  # noqa: E402,I001
from repro_torch.fedsrv.client import FedClient, PullResult  # noqa: E402
from repro_torch.fedsrv.server import (FederationHTTPServer,  # noqa: E402
                                       FederationServer, hetero_w0_digest,
                                       init_global_state, start_http_server,
                                       w0_digest)

__all__ = ["AdapterCodec", "AsyncBufferCoordinator", "BytesLedger", "CODECS",
           "ClientInfo", "ClientRegistry", "DROPOUT_STREAM", "Delivery",
           "EncodedTensor", "FAULT_KINDS", "FAULT_STREAM", "FaultInjector",
           "FaultPlan", "FaultSpec", "FedClient", "FederationHTTPServer",
           "FederationServer", "LedgerEntry", "Payload", "PullResult",
           "RoundCoordinator", "RoundOutcome", "RoundPolicy", "SimClock",
           "StaleUplinkError", "StragglerModel", "TransientTransportError",
           "TransportError", "UplinkResult", "ValidationPolicy",
           "hetero_w0_digest", "init_global_state", "payload_from_wire",
           "payload_to_wire", "purpose_rng", "start_http_server",
           "w0_digest"]
