"""Federation orchestration of the port: client registry, sampling, the
synchronous and FedBuff coordinators, the uplink transport and seeded fault
injection (counterpart of ``repro/fedsrv`` without obs and HTTP)."""

from repro_torch.fedsrv.coordinator import (AsyncBufferCoordinator, Delivery,
                                            RoundCoordinator, RoundOutcome,
                                            RoundPolicy, UplinkResult)
from repro_torch.fedsrv.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.fedsrv.registry import (DROPOUT_STREAM, FAULT_STREAM,
                                         ClientInfo, ClientRegistry, SimClock,
                                         StragglerModel, purpose_rng)
from repro_torch.fedsrv.transport import (CODECS, AdapterCodec, BytesLedger,
                                          EncodedTensor, LedgerEntry, Payload,
                                          StaleUplinkError,
                                          TransientTransportError,
                                          TransportError, ValidationPolicy)

__all__ = ["AdapterCodec", "AsyncBufferCoordinator", "BytesLedger", "CODECS",
           "ClientInfo", "ClientRegistry", "DROPOUT_STREAM", "Delivery",
           "EncodedTensor", "FAULT_STREAM", "FaultInjector", "FaultPlan",
           "FaultSpec", "LedgerEntry", "Payload", "RoundCoordinator",
           "RoundOutcome", "RoundPolicy", "SimClock", "StaleUplinkError",
           "StragglerModel", "TransientTransportError", "TransportError",
           "UplinkResult", "ValidationPolicy", "purpose_rng"]
