"""Federation orchestration of the port: client registry, sampling, and the
synchronous round coordinator (counterpart of ``repro/fedsrv``)."""

from repro_torch.fedsrv.coordinator import (Delivery, RoundCoordinator,
                                            RoundOutcome, RoundPolicy)
from repro_torch.fedsrv.registry import (ClientInfo, ClientRegistry, SimClock,
                                         StragglerModel, purpose_rng)

__all__ = ["ClientInfo", "ClientRegistry", "Delivery", "RoundCoordinator",
           "RoundOutcome", "RoundPolicy", "SimClock", "StragglerModel",
           "purpose_rng"]
