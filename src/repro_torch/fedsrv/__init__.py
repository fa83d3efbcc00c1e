"""Federation orchestration of the port: client registry, sampling, the
synchronous and FedBuff coordinators, and the uplink transport (counterpart
of ``repro/fedsrv`` without faults, obs and HTTP)."""

from repro_torch.fedsrv.coordinator import (AsyncBufferCoordinator, Delivery,
                                            RoundCoordinator, RoundOutcome,
                                            RoundPolicy, UplinkResult)
from repro_torch.fedsrv.registry import (DROPOUT_STREAM, ClientInfo,
                                         ClientRegistry, SimClock,
                                         StragglerModel, purpose_rng)
from repro_torch.fedsrv.transport import (CODECS, AdapterCodec, BytesLedger,
                                          EncodedTensor, LedgerEntry, Payload,
                                          StaleUplinkError,
                                          TransientTransportError,
                                          TransportError, ValidationPolicy)

__all__ = ["AdapterCodec", "AsyncBufferCoordinator", "BytesLedger", "CODECS",
           "ClientInfo", "ClientRegistry", "DROPOUT_STREAM", "Delivery",
           "EncodedTensor", "LedgerEntry", "Payload", "RoundCoordinator",
           "RoundOutcome", "RoundPolicy", "SimClock", "StaleUplinkError",
           "StragglerModel", "TransientTransportError", "TransportError",
           "UplinkResult", "ValidationPolicy", "purpose_rng"]
