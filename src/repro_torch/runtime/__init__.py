from repro_torch.runtime.ft import (SimulatedPreemption,  # noqa: F401
                                    StragglerMonitor, StragglerReport)
from repro_torch.runtime.faults import (AdapterUnavailable,  # noqa: F401
                                        EngineWatchdog, FaultInjector,
                                        FaultPlan, RequestShed, ServingError,
                                        SlotPoisoned, StoreError,
                                        TableBuildError)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
